"""Foreign-toolchain guest builds: LLVM's RISC-V backend via libLLVM.

The reference proves guests built by a FOREIGN compiler (powdr invokes
rustc/LLVM for the RISC-V target, the reference's zkvm/src/lib.rs:172).
Every guest proven here so far came from in-repo tooling (the hand
assembler or zkvm/cc.py, which is -O0-shaped by design), so the RV32
decoder and machine semantics had never faced real optimizer codegen.

This module closes that: it drives the system `libLLVM-15.so.1` (the
full LLVM distribution library, RISC-V backend included) through the
LLVM-C API with ctypes — textual LLVM IR in, `default<O2>` pass
pipeline, RV32IM instruction selection / scheduling / register
allocation, ELF object out — then links the object with a from-scratch
RV32 static linker (R_RISCV_* relocations) into an executable our
loader (zkvm/elf.py) and machine prove unchanged.

What this exercises that cc.py never emits: auipc-relative data
addressing (forced via the Medium/`medany` code model), magic-number
signed division (mulh + srai + add sequences), optimizer branch
funnels, dense loop rotation/strength reduction, and mulh/mulhu/mulhsu
from widening i64 multiplies.

No compiled binding: pure ctypes against the C API.

Copy of eigen_zkvm_tpu/zkvm/llvm_backend.py for the PyTorch port, on the
port's elf; `available()` is False where libLLVM-15 is missing."""
from __future__ import annotations

import ctypes
import struct
from dataclasses import dataclass, field

# layout mirrors cc.py's guest convention (data+stack inside the RAM
# image, .text excluded from the continuation digest)
DATA_VADDR = 0x100
STACK_TOP = 0x4000
TEXT_VADDR = 0x8000

_LIB_PATHS = ("libLLVM-15.so.1", "libLLVM.so.15",
              "/usr/lib/x86_64-linux-gnu/libLLVM-15.so.1")

_llvm = None


def _get_llvm():
    global _llvm
    if _llvm is not None:
        return _llvm or None
    lib = None
    for p in _LIB_PATHS:
        try:
            lib = ctypes.CDLL(p)
            break
        except OSError:
            continue
    if lib is None:
        _llvm = False
        return None
    c = ctypes.c_void_p
    cp = ctypes.POINTER(ctypes.c_char_p)
    lib.LLVMContextCreate.restype = c
    lib.LLVMCreateMemoryBufferWithMemoryRangeCopy.restype = c
    lib.LLVMCreateMemoryBufferWithMemoryRangeCopy.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p]
    lib.LLVMParseIRInContext.restype = ctypes.c_int
    lib.LLVMParseIRInContext.argtypes = [c, c, ctypes.POINTER(c), cp]
    lib.LLVMGetTargetFromTriple.restype = ctypes.c_int
    lib.LLVMGetTargetFromTriple.argtypes = [ctypes.c_char_p,
                                            ctypes.POINTER(c), cp]
    lib.LLVMCreateTargetMachine.restype = c
    lib.LLVMCreateTargetMachine.argtypes = [
        c, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.LLVMSetTarget.argtypes = [c, ctypes.c_char_p]
    lib.LLVMCreateTargetDataLayout.restype = c
    lib.LLVMCreateTargetDataLayout.argtypes = [c]
    lib.LLVMCopyStringRepOfTargetData.restype = ctypes.c_char_p
    lib.LLVMCopyStringRepOfTargetData.argtypes = [c]
    lib.LLVMSetDataLayout.argtypes = [c, ctypes.c_char_p]
    lib.LLVMCreatePassBuilderOptions.restype = c
    lib.LLVMRunPasses.restype = c
    lib.LLVMRunPasses.argtypes = [c, ctypes.c_char_p, c, c]
    lib.LLVMTargetMachineEmitToMemoryBuffer.restype = ctypes.c_int
    lib.LLVMTargetMachineEmitToMemoryBuffer.argtypes = [
        c, c, ctypes.c_int, cp, ctypes.POINTER(c)]
    lib.LLVMGetBufferStart.restype = ctypes.POINTER(ctypes.c_char)
    lib.LLVMGetBufferStart.argtypes = [c]
    lib.LLVMGetBufferSize.restype = ctypes.c_size_t
    lib.LLVMGetBufferSize.argtypes = [c]
    lib.LLVMDisposeMemoryBuffer.argtypes = [c]
    lib.LLVMInitializeRISCVTargetInfo()
    lib.LLVMInitializeRISCVTarget()
    lib.LLVMInitializeRISCVTargetMC()
    lib.LLVMInitializeRISCVAsmPrinter()
    lib.LLVMInitializeRISCVAsmParser()  # module-level asm (_start stub)
    _llvm = lib
    return lib


def available() -> bool:
    return _get_llvm() is not None


TRIPLE = b"riscv32-unknown-elf"
# no compressed instructions (the machine decodes RV32IM only), no
# linker-relaxation relocs (this linker does not relax)
FEATURES = b"+m,-c,-relax,-a,-f,-d"


def compile_ir(ir_text: str, opt: str = "default<O2>") -> bytes:
    """Textual LLVM IR -> RV32IM ELF relocatable object bytes, compiled
    by LLVM's own RISC-V backend at -O2 (codegen level Aggressive)."""
    lib = _get_llvm()
    assert lib is not None, "libLLVM unavailable"
    c = ctypes.c_void_p
    ctx = lib.LLVMContextCreate()
    data = ir_text.encode()
    buf = lib.LLVMCreateMemoryBufferWithMemoryRangeCopy(
        data, len(data), b"guest.ll")
    mod = c()
    err = ctypes.c_char_p()
    if lib.LLVMParseIRInContext(ctx, buf, ctypes.byref(mod),
                                ctypes.byref(err)):
        raise ValueError(f"LLVM IR parse error: {err.value!r}")
    tgt = c()
    if lib.LLVMGetTargetFromTriple(TRIPLE, ctypes.byref(tgt),
                                   ctypes.byref(err)):
        raise RuntimeError(f"no riscv32 target: {err.value!r}")
    # CodeGenLevel 3 = Aggressive; Reloc 0 = default (static);
    # CodeModel 5 = Medium (riscv `medany`) -> auipc-relative data access
    tm = lib.LLVMCreateTargetMachine(tgt, TRIPLE, b"generic-rv32",
                                     FEATURES, 3, 0, 5)
    lib.LLVMSetTarget(mod, TRIPLE)
    td = lib.LLVMCreateTargetDataLayout(tm)
    lib.LLVMSetDataLayout(mod, lib.LLVMCopyStringRepOfTargetData(td))
    pbo = lib.LLVMCreatePassBuilderOptions()
    perr = lib.LLVMRunPasses(mod, opt.encode(), tm, pbo)
    if perr:
        raise RuntimeError("LLVM pass pipeline failed")
    out = c()
    if lib.LLVMTargetMachineEmitToMemoryBuffer(
            tm, mod, 1, ctypes.byref(err), ctypes.byref(out)):  # 1 = object
        raise RuntimeError(f"LLVM codegen failed: {err.value!r}")
    size = lib.LLVMGetBufferSize(out)
    obj = ctypes.string_at(lib.LLVMGetBufferStart(out), size)
    lib.LLVMDisposeMemoryBuffer(out)
    return obj


# ---------------------------------------------------------------------------
# Minimal RV32 static linker for LLVM-emitted ET_REL objects.
# ---------------------------------------------------------------------------

# ELF section header fields
SHT_PROGBITS, SHT_SYMTAB, SHT_STRTAB, SHT_RELA, SHT_NOBITS = 1, 2, 3, 4, 8
SHF_ALLOC, SHF_EXECINSTR = 0x2, 0x4

# RISC-V relocation types (psABI)
R_32 = 1
R_BRANCH = 16
R_JAL = 17
R_CALL = 18
R_CALL_PLT = 19
R_PCREL_HI20 = 23
R_PCREL_LO12_I = 24
R_PCREL_LO12_S = 25
R_HI20 = 26
R_LO12_I = 27
R_LO12_S = 28
R_RELAX = 51
R_ALIGN = 43


@dataclass
class _Section:
    name: str
    type_: int
    flags: int
    data: bytearray
    addralign: int
    index: int
    addr: int = 0


@dataclass
class _Sym:
    name: str
    value: int
    shndx: int
    info: int
    addr: int = 0


@dataclass
class _Rela:
    offset: int
    type_: int
    sym: int
    addend: int


@dataclass
class LinkedImage:
    elf: bytes
    entry: int
    symbols: dict = field(default_factory=dict)


def _parse_object(obj: bytes):
    (_mag, _cls, _end, _ver, _abi) = struct.unpack_from("<4sBBBB", obj, 0)
    assert _mag == b"\x7fELF" and _cls == 1, "not ELF32"
    (e_type, e_machine, _v, _entry, _phoff, e_shoff, _flags, _ehsize,
     _phes, _phnum, e_shentsize, e_shnum, e_shstrndx) = struct.unpack_from(
        "<HHIIIIIHHHHHH", obj, 16)
    assert e_type == 1 and e_machine == 243, "not an ET_REL RISC-V object"
    shs = []
    for i in range(e_shnum):
        off = e_shoff + i * e_shentsize
        (sh_name, sh_type, sh_flags, sh_addr, sh_offset, sh_size, sh_link,
         sh_info, sh_addralign, sh_entsize) = struct.unpack_from(
            "<10I", obj, off)
        shs.append((sh_name, sh_type, sh_flags, sh_addr, sh_offset,
                    sh_size, sh_link, sh_info, sh_addralign, sh_entsize))
    shstr = shs[e_shstrndx]
    strtab_raw = obj[shstr[4] : shstr[4] + shstr[5]]

    def sname(off):
        end = strtab_raw.index(b"\0", off)
        return strtab_raw[off:end].decode()

    sections: dict[int, _Section] = {}
    symtab = None
    symstr = b""
    relas: dict[int, list[_Rela]] = {}
    for i, sh in enumerate(shs):
        name = sname(sh[0])
        if sh[1] in (SHT_PROGBITS, SHT_NOBITS) and sh[2] & SHF_ALLOC:
            data = bytearray(sh[5]) if sh[1] == SHT_NOBITS else bytearray(
                obj[sh[4] : sh[4] + sh[5]])
            sections[i] = _Section(name, sh[1], sh[2], data,
                                   max(sh[8], 1), i)
        elif sh[1] == SHT_SYMTAB:
            symtab = obj[sh[4] : sh[4] + sh[5]]
            link = shs[sh[6]]
            symstr = obj[link[4] : link[4] + link[5]]
        elif sh[1] == SHT_RELA:
            lst = []
            for off in range(sh[4], sh[4] + sh[5], sh[9] or 12):
                r_off, r_info, r_add = struct.unpack_from("<IIi", obj, off)
                lst.append(_Rela(r_off, r_info & 0xFF, r_info >> 8, r_add))
            relas[sh[7]] = relas.get(sh[7], []) + lst  # sh_info = target
    syms: list[_Sym] = []
    assert symtab is not None, "object has no symbol table"
    for off in range(0, len(symtab), 16):
        st_name, st_value, _st_size, st_info, _st_other, st_shndx = \
            struct.unpack_from("<IIIBBH", symtab, off)
        end = symstr.index(b"\0", st_name)
        syms.append(_Sym(symstr[st_name:end].decode(), st_value, st_shndx,
                         st_info))
    return sections, syms, relas


def _enc_hi20(word: int, value: int) -> int:
    return (word & 0xFFF) | (value & 0xFFFFF000)


def _enc_lo12_i(word: int, value: int) -> int:
    return (word & 0xFFFFF) | ((value & 0xFFF) << 20)


def _enc_lo12_s(word: int, value: int) -> int:
    v = value & 0xFFF
    return ((word & 0x1FFF07F) | ((v & 0x1F) << 7)
            | ((v >> 5) << 25))


def _enc_branch(word: int, off: int) -> int:
    assert -4096 <= off < 4096 and off % 2 == 0, f"branch off {off}"
    return ((word & 0x01FFF07F)
            | (((off >> 11) & 1) << 7) | (((off >> 1) & 0xF) << 8)
            | (((off >> 5) & 0x3F) << 25) | (((off >> 12) & 1) << 31))


def _enc_jal(word: int, off: int) -> int:
    assert -(1 << 20) <= off < (1 << 20) and off % 2 == 0, f"jal off {off}"
    return ((word & 0xFFF)
            | (((off >> 12) & 0xFF) << 12) | (((off >> 11) & 1) << 20)
            | (((off >> 1) & 0x3FF) << 21) | (((off >> 20) & 1) << 31))


def _hi(delta: int) -> int:
    """Round-to-nearest-4K high part, mod 2^32 (negative deltas wrap the
    way auipc's 32-bit add does)."""
    return ((delta + 0x800) & 0xFFFFF000) & 0xFFFFFFFF


def link_rv32(obj: bytes, entry_symbol: str = "_start") -> LinkedImage:
    """Link ONE relocatable object into an executable ELF image at the
    guest layout (TEXT_VADDR / DATA_VADDR).  Static, no relaxation."""
    sections, syms, relas = _parse_object(obj)

    text_secs = [s for s in sections.values() if s.flags & SHF_EXECINSTR]
    data_secs = [s for s in sections.values()
                 if not (s.flags & SHF_EXECINSTR) and s.type_ == SHT_PROGBITS]
    bss_secs = [s for s in sections.values() if s.type_ == SHT_NOBITS]

    def lay(secs, base):
        cur = base
        for s in sorted(secs, key=lambda x: x.index):
            cur = (cur + s.addralign - 1) & ~(s.addralign - 1)
            s.addr = cur
            cur += len(s.data)
        return cur

    text_end = lay(text_secs, TEXT_VADDR)
    # +4: word 0 of the data blob is a span marker (below), owned by no
    # symbol — guests whose globals are all zero-initialized still get a
    # RAM image covering [DATA_VADDR, STACK_TOP) for the stack
    data_end = lay(data_secs + bss_secs, DATA_VADDR + 4)
    assert data_end <= STACK_TOP - 512, "data collides with the stack"
    assert text_end < 1 << 24

    for sym in syms:
        if sym.shndx in sections:
            sym.addr = sections[sym.shndx].addr + sym.value
        elif sym.shndx == 0xFFF1:  # SHN_ABS
            sym.addr = sym.value
        elif sym.shndx == 0 and sym.name:
            raise ValueError(f"undefined symbol {sym.name!r} "
                             "(guests must be freestanding)")

    # apply relocations
    for target_idx, lst in relas.items():
        if target_idx not in sections:
            continue  # .debug/.eh_frame etc.
        sec = sections[target_idx]
        by_off = {r.offset: r for r in lst}
        for r in lst:
            if r.type_ in (R_RELAX, R_ALIGN):
                continue
            P = sec.addr + r.offset

            def rd():
                return int.from_bytes(sec.data[r.offset : r.offset + 4],
                                      "little")

            def wr(w):
                sec.data[r.offset : r.offset + 4] = int(w & 0xFFFFFFFF) \
                    .to_bytes(4, "little")

            if r.type_ in (R_PCREL_LO12_I, R_PCREL_LO12_S):
                # the symbol points AT the auipc site; its own reloc
                # (PCREL_HI20) defines the real target
                hi_site = syms[r.sym].addr
                hi_rel = by_off.get(hi_site - sec.addr)
                assert hi_rel is not None and hi_rel.type_ == R_PCREL_HI20, \
                    "dangling pcrel_lo12"
                delta = syms[hi_rel.sym].addr + hi_rel.addend - hi_site
                lo = (delta - _hi(delta)) & 0xFFF
                enc = _enc_lo12_i if r.type_ == R_PCREL_LO12_I \
                    else _enc_lo12_s
                wr(enc(rd(), lo))
                continue
            S = syms[r.sym].addr + r.addend
            if r.type_ == R_32:
                wr(S)
            elif r.type_ == R_HI20:
                wr(_enc_hi20(rd(), _hi(S)))
            elif r.type_ == R_LO12_I:
                wr(_enc_lo12_i(rd(), S))
            elif r.type_ == R_LO12_S:
                wr(_enc_lo12_s(rd(), S))
            elif r.type_ == R_PCREL_HI20:
                wr(_enc_hi20(rd(), _hi(S - P)))
            elif r.type_ in (R_CALL, R_CALL_PLT):
                delta = S - P
                auipc = rd()
                jalr = int.from_bytes(sec.data[r.offset + 4 : r.offset + 8],
                                      "little")
                sec.data[r.offset : r.offset + 4] = \
                    _enc_hi20(auipc, _hi(delta)).to_bytes(4, "little")
                sec.data[r.offset + 4 : r.offset + 8] = \
                    _enc_lo12_i(jalr, delta - _hi(delta)) \
                    .to_bytes(4, "little")
            elif r.type_ == R_BRANCH:
                wr(_enc_branch(rd(), S - P))
            elif r.type_ == R_JAL:
                wr(_enc_jal(rd(), S - P))
            else:
                raise NotImplementedError(f"relocation type {r.type_}")

    # assemble the final image: text blob + one data blob padded so the
    # RAM image spans [DATA_VADDR, STACK_TOP) (cc.py stack convention)
    text_blob = bytearray(text_end - TEXT_VADDR)
    for s in text_secs:
        off = s.addr - TEXT_VADDR
        text_blob[off : off + len(s.data)] = s.data
    data_blob = bytearray(STACK_TOP - DATA_VADDR)
    for s in data_secs + bss_secs:
        off = s.addr - DATA_VADDR
        data_blob[off : off + len(s.data)] = s.data
    data_blob[:4] = b"\xa5\x00\x00\x00"   # span markers: the loader's
    data_blob[-4:] = b"\x5a\x00\x00\x00"  # image covers first..last nonzero

    entry = None
    symmap = {}
    for sym in syms:
        if sym.name:
            symmap[sym.name] = sym.addr
    entry = symmap.get(entry_symbol)
    assert entry is not None, f"no {entry_symbol!r} in object"

    from .elf import make_elf

    words = [int.from_bytes(text_blob[i : i + 4], "little")
             for i in range(0, len(text_blob), 4)]
    elf = make_elf(words, entry=entry, text_vaddr=TEXT_VADDR,
                   data_bytes=bytes(data_blob), data_vaddr=DATA_VADDR)
    return LinkedImage(elf=elf, entry=entry, symbols=symmap)


START_ASM = (
    'module asm ".globl _start"\n'
    'module asm "_start:"\n'
    f'module asm "  li sp, {STACK_TOP}"\n'
    'module asm "  call main"\n'
    'module asm "  ecall"\n')


def ir_to_elf(ir_text: str, opt: str = "default<O2>") -> bytes:
    """LLVM IR (with a `main`) -> proven-format ELF: prepends the _start
    stub, compiles with LLVM's RV32 backend, links."""
    return link_rv32(compile_ir(START_ASM + ir_text, opt)).elf
