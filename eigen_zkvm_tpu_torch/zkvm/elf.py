"""ELF32 RISC-V loader: prove real compiled binaries.

The reference compiles Rust guests to RISC-V ELF via powdr
(zkvm/src/lib.rs:168 compile_rust) and proves the resulting machine
code.  This is the loading half of that capability for the native
RV32IM front-end (zkvm/rv32.py): parse a little-endian ELF32
(e_machine=243), map PT_LOAD segments, decode executable words into the
proved program, and pack writable data into the word-addressed RAM
image that the memory-continuation coprocessor digests.

No toolchain is bundled, so `make_elf` can also EMIT a minimal valid
ELF32 around assembled words — used by tests to round-trip the loader
and as a container format for guests built elsewhere.
"""
from __future__ import annotations

import struct

from .rv32_isa import RvInstr, decode

EM_RISCV = 243
PT_LOAD = 1
PF_X = 1


class ElfError(ValueError):
    pass


def load_elf(src, include_exec_in_image: bool = True):
    """Parse an ELF32 RISC-V executable (bytes, or a path).

    `include_exec_in_image=False` keeps PF_X segment words out of the RAM
    image (guests that never read .text — e.g. cc.py output, which loads
    constants via lui/addi, not literal pools — get a much smaller
    continuation-digest footprint).

    Returns (program, entry, image0, ram_words, mem_base):
      program   — byte-pc -> RvInstr for every decodable word in PF_X
                  segments
      entry     — e_entry
      image0    — numpy uint64 word array covering ALL loaded segments
                  (index = word address - mem_base; .text words included
                  so literal pools are loadable), or None with no data
      ram_words — len(image0), a power of two (0 if image0 is None)
      mem_base  — word-address origin of image0: real linkers place
                  segments at conventional bases (0x10000 ld default,
                  0x80000000 embedded), so the image covers min..max
                  loaded word addresses, not 0..max
    """
    import numpy as np

    if isinstance(src, str):
        with open(src, "rb") as f:
            data = f.read()
    else:
        data = src
    if len(data) < 52 or data[:4] != b"\x7fELF":
        raise ElfError("not an ELF file")
    ei_class, ei_data = data[4], data[5]
    if ei_class != 1:
        raise ElfError("need ELFCLASS32 (RV32 guest)")
    if ei_data != 1:
        raise ElfError("need little-endian ELF")
    (e_type, e_machine, _ver, e_entry, e_phoff, _shoff, _flags, _ehsize,
     e_phentsize, e_phnum) = struct.unpack_from("<HHIIIIIHHH", data, 16)
    if e_machine != EM_RISCV:
        raise ElfError(f"e_machine {e_machine} is not RISC-V ({EM_RISCV})")
    if e_type not in (2, 3):  # ET_EXEC / ET_DYN (PIE linked at 0)
        raise ElfError(f"unsupported e_type {e_type}")

    program: dict[int, RvInstr] = {}
    data_words: dict[int, int] = {}  # word addr -> u32
    for i in range(e_phnum):
        off = e_phoff + i * e_phentsize
        (p_type, p_offset, p_vaddr, _paddr, p_filesz, p_memsz, p_flags,
         _align) = struct.unpack_from("<IIIIIIII", data, off)
        if p_type != PT_LOAD:
            continue
        if p_vaddr & 3:
            raise ElfError(f"unaligned PT_LOAD vaddr {p_vaddr:#x}")
        seg = data[p_offset : p_offset + p_filesz]
        seg = seg + b"\x00" * (p_memsz - len(seg))
        words = [int.from_bytes(seg[j : j + 4].ljust(4, b"\x00"), "little")
                 for j in range(0, len(seg), 4)]
        for j, w in enumerate(words):
            if p_flags & PF_X:
                pc = p_vaddr + 4 * j
                try:
                    program[pc] = decode(w, pc)
                except Exception:
                    pass  # literal pools / padding inside .text
                if not include_exec_in_image:
                    continue
            if w:
                data_words[(p_vaddr >> 2) + j] = w

    if not program:
        raise ElfError("no executable PT_LOAD segment")
    image0 = None
    ram_words = 0
    mem_base = 0
    if data_words:
        mem_base = min(data_words) & ~7  # 8-word aligned image origin
        top = max(data_words) + 1 - mem_base
        ram_words = 1
        while ram_words < top:
            ram_words <<= 1
        if ram_words > (1 << 26):  # 256 MiB of u64 image — not a guest
            raise ElfError(
                f"loaded segments span {ram_words} words from base "
                f"{mem_base:#x}; image too large for the continuation "
                "coprocessor (sparse/huge layouts are not guest-shaped)")
        image0 = np.zeros(ram_words, dtype=np.uint64)
        for wa, w in data_words.items():
            image0[wa - mem_base] = w
    return program, e_entry, image0, ram_words, mem_base


def make_elf(text_words, entry: int = 0, text_vaddr: int = 0,
             data_bytes: bytes = b"", data_vaddr: int = 0x1000) -> bytes:
    """Emit a minimal valid ELF32 RISC-V executable around raw
    instruction words (+ optional data segment)."""
    text = b"".join(int(w).to_bytes(4, "little") for w in text_words)
    phnum = 1 + (1 if data_bytes else 0)
    ehsize, phentsize = 52, 32
    text_off = ehsize + phnum * phentsize
    data_off = text_off + len(text)
    eh = struct.pack(
        "<4sBBBBB7xHHIIIIIHHHHHH",
        b"\x7fELF", 1, 1, 1, 0, 0,       # class32, LE, version, SysV ABI
        2, EM_RISCV, 1,                   # ET_EXEC, RISC-V, EV_CURRENT
        entry, ehsize, 0, 0,              # e_entry, e_phoff, e_shoff, flags
        ehsize, phentsize, phnum, 0, 0, 0)
    phs = struct.pack("<IIIIIIII", PT_LOAD, text_off, text_vaddr,
                      text_vaddr, len(text), len(text), PF_X | 4, 4)
    if data_bytes:
        phs += struct.pack("<IIIIIIII", PT_LOAD, data_off, data_vaddr,
                           data_vaddr, len(data_bytes), len(data_bytes),
                           6, 4)  # RW
    return eh + phs + text + data_bytes


def load_c_elf(elf: bytes):
    """Loader shim: cc binaries never read .text, so the RAM image (and
    the continuation digest) covers only data + stack."""
    return load_elf(elf, include_exec_in_image=False)


def elf_execute_and_prove(elf_data: bytes, n_bits: int = 12,
                          n_queries: int = 2, regs0=None,
                          rows_budget: int | None = None,
                          include_exec_in_image: bool = True, device=None):
    """Load an ELF and prove its execution on `device` (zkvm/src/lib.rs:231
    prove analog for a compiled binary).  Returns the
    rv32_execute_and_prove result."""
    from .rv32_lib import rv32_execute_and_prove

    program, entry, image0, ram_words, mem_base = load_elf(
        elf_data, include_exec_in_image=include_exec_in_image)
    return rv32_execute_and_prove(
        program, entry=entry, n_bits=n_bits, n_queries=n_queries,
        regs0=regs0, ram_words=ram_words or None, image0=image0,
        rows_budget=rows_budget, mem_base=mem_base, device=device)
