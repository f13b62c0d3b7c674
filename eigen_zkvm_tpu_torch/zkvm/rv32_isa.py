"""RV32IM front-end: real instruction encodings — decoder, assembler,
executor, ELF loader.

The reference proves RISC-V guests through the external powdr toolchain
(zkvm/src/lib.rs:172 compile_rust -> RV32 ELF -> powdr-asm).  This module is
the native replacement for the front half: it ingests REAL RV32IM machine
code (raw words or a compiled ELF) and produces the decoded program +
execution trace that zkvm/rv32.py arithmetizes.  The in-repo assembler
emits bit-exact standard encodings (verified against the decoder round-trip
and golden words in tests/test_rv32.py) so guests can be authored without a
cross-compiler; compiled ELFs load through pyelftools.

Semantics notes (RV32IM, unprivileged spec):
  - word machine, byte-addressed loads/stores (lb/lbu/lh/lhu/sb/sh expand
    to read-modify-write micro-cycles in the arithmetization)
  - div/rem follow the spec: div-by-zero -> q=-1, r=a; signed overflow
    (MIN_INT / -1) -> q=MIN_INT, r=0
  - ecall halts (guest results live in registers/memory); fence/ebreak nop

Copy of eigen_zkvm_tpu/zkvm/rv32_isa.py for the PyTorch port.
"""
from __future__ import annotations

from dataclasses import dataclass

WORD = 1 << 32
MASK32 = WORD - 1

# canonical op names used by the machine PIL
R_OPS = {
    (0b0110011, 0b000, 0b0000000): "add",
    (0b0110011, 0b000, 0b0100000): "sub",
    (0b0110011, 0b001, 0b0000000): "sll",
    (0b0110011, 0b010, 0b0000000): "slt",
    (0b0110011, 0b011, 0b0000000): "sltu",
    (0b0110011, 0b100, 0b0000000): "xor",
    (0b0110011, 0b101, 0b0000000): "srl",
    (0b0110011, 0b101, 0b0100000): "sra",
    (0b0110011, 0b110, 0b0000000): "or",
    (0b0110011, 0b111, 0b0000000): "and",
    (0b0110011, 0b000, 0b0000001): "mul",
    (0b0110011, 0b001, 0b0000001): "mulh",
    (0b0110011, 0b010, 0b0000001): "mulhsu",
    (0b0110011, 0b011, 0b0000001): "mulhu",
    (0b0110011, 0b100, 0b0000001): "div",
    (0b0110011, 0b101, 0b0000001): "divu",
    (0b0110011, 0b110, 0b0000001): "rem",
    (0b0110011, 0b111, 0b0000001): "remu",
}
I_OPS = {
    (0b0010011, 0b000): "addi",
    (0b0010011, 0b010): "slti",
    (0b0010011, 0b011): "sltiu",
    (0b0010011, 0b100): "xori",
    (0b0010011, 0b110): "ori",
    (0b0010011, 0b111): "andi",
}
SHIFT_I = {(0b001, 0b0000000): "slli", (0b101, 0b0000000): "srli",
           (0b101, 0b0100000): "srai"}
LOADS = {0b000: "lb", 0b001: "lh", 0b010: "lw", 0b100: "lbu", 0b101: "lhu"}
STORES = {0b000: "sb", 0b001: "sh", 0b010: "sw"}
BRANCHES = {0b000: "beq", 0b001: "bne", 0b100: "blt", 0b101: "bge",
            0b110: "bltu", 0b111: "bgeu"}

ALL_OPS = (sorted(set(R_OPS.values())) + sorted(set(I_OPS.values()))
           + sorted(set(SHIFT_I.values())) + sorted(LOADS.values())
           + sorted(STORES.values()) + sorted(BRANCHES.values())
           + ["lui", "auipc", "jal", "jalr", "ecall", "fence"])


@dataclass
class RvInstr:
    op: str
    rd: int = 0
    rs1: int = 0
    rs2: int = 0
    imm: int = 0       # sign-extended where applicable, as python int
    raw: int = 0       # original 32-bit encoding

    def key(self):
        return (self.op, self.rd, self.rs1, self.rs2, self.imm & MASK32)


def _sext(v: int, bits: int) -> int:
    v &= (1 << bits) - 1
    return v - (1 << bits) if v & (1 << (bits - 1)) else v


def decode(word: int, pc: int = 0) -> RvInstr:
    """Decode one 32-bit RV32IM instruction word."""
    opc = word & 0x7F
    rd = (word >> 7) & 0x1F
    f3 = (word >> 12) & 0x7
    rs1 = (word >> 15) & 0x1F
    rs2 = (word >> 20) & 0x1F
    f7 = (word >> 25) & 0x7F
    if opc == 0b0110011:
        op = R_OPS.get((opc, f3, f7))
        if op:
            return RvInstr(op, rd, rs1, rs2, 0, word)
    elif opc == 0b0010011:
        if f3 in (0b001, 0b101):
            op = SHIFT_I.get((f3, f7))
            if op:
                return RvInstr(op, rd, rs1, 0, rs2, word)  # imm = shamt
        else:
            op = I_OPS.get((opc, f3))
            if op:
                return RvInstr(op, rd, rs1, 0, _sext(word >> 20, 12), word)
    elif opc == 0b0000011:
        op = LOADS.get(f3)
        if op:
            return RvInstr(op, rd, rs1, 0, _sext(word >> 20, 12), word)
    elif opc == 0b0100011:
        op = STORES.get(f3)
        if op:
            imm = _sext(((word >> 25) << 5) | rd, 12)
            return RvInstr(op, 0, rs1, rs2, imm, word)
    elif opc == 0b1100011:
        op = BRANCHES.get(f3)
        if op:
            imm = _sext((((word >> 31) & 1) << 12) | (((word >> 7) & 1) << 11)
                        | (((word >> 25) & 0x3F) << 5)
                        | (((word >> 8) & 0xF) << 1), 13)
            return RvInstr(op, 0, rs1, rs2, imm, word)
    elif opc == 0b0110111:
        return RvInstr("lui", rd, 0, 0, word & 0xFFFFF000, word)
    elif opc == 0b0010111:
        return RvInstr("auipc", rd, 0, 0, word & 0xFFFFF000, word)
    elif opc == 0b1101111:
        imm = _sext((((word >> 31) & 1) << 20) | (((word >> 12) & 0xFF) << 12)
                    | (((word >> 20) & 1) << 11)
                    | (((word >> 21) & 0x3FF) << 1), 21)
        return RvInstr("jal", rd, 0, 0, imm, word)
    elif opc == 0b1100111 and f3 == 0:
        return RvInstr("jalr", rd, rs1, 0, _sext(word >> 20, 12), word)
    elif opc == 0b1110011:
        return RvInstr("ecall", 0, 0, 0, 0, word)  # ecall/ebreak both halt
    elif opc == 0b0001111:
        return RvInstr("fence", 0, 0, 0, 0, word)
    raise ValueError(f"cannot decode 0x{word:08x} at pc {pc:#x}")


# ---- assembler (emits real encodings; labels resolved in pass 2) ----

_REG_NAMES = {"zero": 0, "ra": 1, "sp": 2, "gp": 3, "tp": 4,
              "fp": 8, "s0": 8, "s1": 9}
_REG_NAMES.update({f"t{i}": v for i, v in enumerate((5, 6, 7, 28, 29, 30, 31))})
_REG_NAMES.update({f"a{i}": 10 + i for i in range(8)})
_REG_NAMES.update({f"s{i}": (8, 9, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27)[i]
                   for i in range(12)})
_REG_NAMES.update({f"x{i}": i for i in range(32)})


def _r(tok: str) -> int:
    tok = tok.strip().rstrip(",")
    if tok in _REG_NAMES:
        return _REG_NAMES[tok]
    raise ValueError(f"bad register {tok!r}")


def _enc_r(op, rd, rs1, rs2):
    opc, f3, f7 = next(k for k, v in R_OPS.items() if v == op)
    return opc | (rd << 7) | (f3 << 12) | (rs1 << 15) | (rs2 << 20) | (f7 << 25)


def _enc_i(opc, f3, rd, rs1, imm):
    return opc | (rd << 7) | (f3 << 12) | (rs1 << 15) | ((imm & 0xFFF) << 20)


def _enc_s(f3, rs1, rs2, imm):
    return (0b0100011 | ((imm & 0x1F) << 7) | (f3 << 12) | (rs1 << 15)
            | (rs2 << 20) | (((imm >> 5) & 0x7F) << 25))


def _enc_b(f3, rs1, rs2, imm):
    return (0b1100011 | (((imm >> 11) & 1) << 7) | (((imm >> 1) & 0xF) << 8)
            | (f3 << 12) | (rs1 << 15) | (rs2 << 20)
            | (((imm >> 5) & 0x3F) << 25) | (((imm >> 12) & 1) << 31))


def _enc_j(rd, imm):
    return (0b1101111 | (rd << 7) | (((imm >> 12) & 0xFF) << 12)
            | (((imm >> 11) & 1) << 20) | (((imm >> 1) & 0x3FF) << 21)
            | (((imm >> 20) & 1) << 31))


_BR_INVERT = {"beq": "bne", "bne": "beq", "blt": "bge", "bge": "blt",
              "bltu": "bgeu", "bgeu": "bltu", "bgt": "ble", "ble": "bgt"}
_BR_SET = set(_BR_INVERT)


def assemble(src: str, base: int = 0) -> list[int]:
    """Assemble RV32IM source (labels, standard mnemonics, common pseudo
    ops) into 32-bit instruction words at byte address `base`.  Branches
    whose label target is outside the B-type ±4 KB range are RELAXED to
    an inverted branch over a jal (compiler output — e.g. the unrolled
    keccak round — routinely exceeds the short range)."""
    lines = []
    for raw in src.splitlines():
        line = raw.split("#")[0].strip()
        if line:
            lines.append(line)
    stmts = []           # (op, args)
    label_defs = []      # (label, stmt index)
    for line in lines:
        while ":" in line:
            lbl, line = line.split(":", 1)
            label_defs.append((lbl.strip(), len(stmts)))
            line = line.strip()
        if not line:
            continue
        toks = line.replace(",", " ").replace("(", " ").replace(")", " ").split()
        stmts.append((toks[0].lower(), toks[1:]))

    # iterate sizing to a fixpoint (branch relaxation only grows)
    sizes = [2 if op == "li" and _needs_two([op] + a) else 1
             for op, a in stmts]
    labels: dict[str, int] = {}
    while True:
        pcs, pc = [], base
        for sz in sizes:
            pcs.append(pc)
            pc += 4 * sz
        labels = {}
        for lbl, idx in label_defs:
            labels[lbl] = pcs[idx] if idx < len(pcs) else pc
        changed = False
        for i, (op, a) in enumerate(stmts):
            if op in _BR_SET and sizes[i] == 1 and a[2] in labels:
                off = labels[a[2]] - pcs[i]
                if not -4096 <= off <= 4094:
                    sizes[i] = 2
                    changed = True
        if not changed:
            break

    parsed = [(pcs[i], op, a, sizes[i]) for i, (op, a) in enumerate(stmts)]
    words: list[int] = []
    for pc, op, a, size in parsed:
        if op in _BR_SET and size == 2:
            # far branch: inverted short branch over an unconditional jal
            inv = _BR_INVERT[op]
            tgt = labels[a[0 + 2]] - (pc + 4)
            if inv in BRANCHES.values():
                f3 = next(k for k, v in BRANCHES.items() if v == inv)
                words.append(_enc_b(f3, _r(a[0]), _r(a[1]), 8))
            else:  # bgt/ble pseudo: swap operands
                f3 = 0b100 if inv == "bgt" else 0b101
                words.append(_enc_b(f3, _r(a[1]), _r(a[0]), 8))
            words.append(_enc_j(0, tgt))
            continue
        def imm(tok, rel=False):
            v = labels[tok] if tok in labels else int(tok, 0)
            return v - pc if rel and tok in labels else v

        if op in set(R_OPS.values()):
            words.append(_enc_r(op, _r(a[0]), _r(a[1]), _r(a[2])))
        elif op in ("addi", "slti", "sltiu", "xori", "ori", "andi"):
            f3 = {"addi": 0, "slti": 2, "sltiu": 3, "xori": 4, "ori": 6,
                  "andi": 7}[op]
            words.append(_enc_i(0b0010011, f3, _r(a[0]), _r(a[1]), imm(a[2])))
        elif op in ("slli", "srli", "srai"):
            f3 = 1 if op == "slli" else 5
            f7 = 0b0100000 if op == "srai" else 0
            words.append(_enc_i(0b0010011, f3, _r(a[0]), _r(a[1]),
                                (f7 << 5) | (imm(a[2]) & 0x1F)))
        elif op in LOADS.values():
            f3 = next(k for k, v in LOADS.items() if v == op)
            words.append(_enc_i(0b0000011, f3, _r(a[0]), _r(a[2]), imm(a[1])))
        elif op in STORES.values():
            f3 = next(k for k, v in STORES.items() if v == op)
            words.append(_enc_s(f3, _r(a[2]), _r(a[0]), imm(a[1])))
        elif op in BRANCHES.values():
            f3 = next(k for k, v in BRANCHES.items() if v == op)
            words.append(_enc_b(f3, _r(a[0]), _r(a[1]), imm(a[2], rel=True)))
        elif op == "lui":
            words.append(0b0110111 | (_r(a[0]) << 7) | ((imm(a[1]) & 0xFFFFF) << 12))
        elif op == "auipc":
            words.append(0b0010111 | (_r(a[0]) << 7) | ((imm(a[1]) & 0xFFFFF) << 12))
        elif op == "jal":
            if len(a) == 1:
                words.append(_enc_j(1, imm(a[0], rel=True)))
            else:
                words.append(_enc_j(_r(a[0]), imm(a[1], rel=True)))
        elif op == "jalr":
            if len(a) == 1:
                words.append(_enc_i(0b1100111, 0, 1, _r(a[0]), 0))
            else:
                words.append(_enc_i(0b1100111, 0, _r(a[0]), _r(a[1]),
                                    imm(a[2]) if len(a) > 2 else 0))
        elif op == "ecall":
            words.append(0x00000073)
        elif op == "ebreak":
            words.append(0x00100073)
        elif op == "fence":
            words.append(0x0000000F)
        # ---- pseudo ops ----
        elif op == "nop":
            words.append(_enc_i(0b0010011, 0, 0, 0, 0))
        elif op == "li":
            v = imm(a[1]) & MASK32
            lo = _sext(v & 0xFFF, 12)
            hi = ((v - lo) >> 12) & 0xFFFFF
            if hi:
                words.append(0b0110111 | (_r(a[0]) << 7) | (hi << 12))
                words.append(_enc_i(0b0010011, 0, _r(a[0]), _r(a[0]), lo))
            else:
                words.append(_enc_i(0b0010011, 0, _r(a[0]), 0, lo))
        elif op == "mv":
            words.append(_enc_i(0b0010011, 0, _r(a[0]), _r(a[1]), 0))
        elif op == "j":
            words.append(_enc_j(0, imm(a[0], rel=True)))
        elif op == "ret":
            words.append(_enc_i(0b1100111, 0, 0, 1, 0))
        elif op == "bgt":
            words.append(_enc_b(0b100, _r(a[1]), _r(a[0]), imm(a[2], rel=True)))
        elif op == "ble":
            words.append(_enc_b(0b101, _r(a[1]), _r(a[0]), imm(a[2], rel=True)))
        else:
            raise ValueError(f"unknown mnemonic {op!r}")
    return words


def _needs_two(toks) -> bool:
    try:
        v = int(toks[2], 0) & MASK32
    except ValueError:
        return True  # label: assume full form
    lo = _sext(v & 0xFFF, 12)
    return ((v - lo) >> 12) & 0xFFFFF != 0


# ---- executor ----

@dataclass
class RvState:
    pc: int
    regs: list
    halted: bool = False
    # (word_addr, old_word, new_word, is_write) memory op records of the
    # cycle that PRODUCED this state (None / tuple)
    mem_op: tuple | None = None


def _s32(v: int) -> int:
    return v - WORD if v & 0x80000000 else v


def execute(program: dict[int, RvInstr], pc0: int, regs0=None,
            mem: dict | None = None, max_cycles: int = 1 << 22):
    """Run decoded RV32IM code.  `program`: byte-pc -> RvInstr.  `mem` is a
    WORD-addressed dict (addr in words).  Returns (states, final)."""
    mem = {} if mem is None else mem
    regs = list(regs0) if regs0 else [0] * 32
    st = RvState(pc0, regs)
    states = [RvState(st.pc, list(regs))]

    def ld_word(wa):
        return mem.get(wa, 0)

    for _ in range(max_cycles):
        ins = program[st.pc]
        op = ins.op
        a = regs[ins.rs1]
        b = regs[ins.rs2]
        npc = st.pc + 4
        val = None
        mem_op = None
        if op == "ecall":
            st.halted = True
            states[-1].halted = True
            break
        if op in ("add", "addi"):
            val = (a + (b if op == "add" else ins.imm)) & MASK32
        elif op == "sub":
            val = (a - b) & MASK32
        elif op in ("and", "andi"):
            val = a & (b if op == "and" else ins.imm & MASK32)
        elif op in ("or", "ori"):
            val = a | (b if op == "or" else ins.imm & MASK32)
        elif op in ("xor", "xori"):
            val = a ^ (b if op == "xor" else ins.imm & MASK32)
        elif op in ("sll", "slli"):
            sh = (b if op == "sll" else ins.imm) & 31
            val = (a << sh) & MASK32
        elif op in ("srl", "srli"):
            sh = (b if op == "srl" else ins.imm) & 31
            val = a >> sh
        elif op in ("sra", "srai"):
            sh = (b if op == "sra" else ins.imm) & 31
            val = (_s32(a) >> sh) & MASK32
        elif op in ("slt", "slti"):
            rhs = _s32(b) if op == "slt" else ins.imm
            val = 1 if _s32(a) < rhs else 0
        elif op in ("sltu", "sltiu"):
            rhs = b if op == "sltu" else ins.imm & MASK32
            val = 1 if a < rhs else 0
        elif op == "mul":
            val = (a * b) & MASK32
        elif op == "mulhu":
            val = (a * b) >> 32
        elif op == "mulh":
            val = ((_s32(a) * _s32(b)) >> 32) & MASK32
        elif op == "mulhsu":
            val = ((_s32(a) * b) >> 32) & MASK32
        elif op in ("divu", "remu"):
            if b == 0:
                val = MASK32 if op == "divu" else a
            else:
                val = a // b if op == "divu" else a % b
        elif op in ("div", "rem"):
            sa, sb = _s32(a), _s32(b)
            if b == 0:
                val = MASK32 if op == "div" else a
            elif sa == -(1 << 31) and sb == -1:
                val = a if op == "div" else 0
            else:
                q = abs(sa) // abs(sb)
                if (sa < 0) != (sb < 0):
                    q = -q
                r = sa - q * sb
                val = (q if op == "div" else r) & MASK32
        elif op == "lui":
            val = ins.imm & MASK32
        elif op == "auipc":
            val = (st.pc + ins.imm) & MASK32
        elif op == "jal":
            val = npc
            npc = (st.pc + ins.imm) & MASK32
        elif op == "jalr":
            val = npc
            npc = (a + ins.imm) & MASK32 & ~1
        elif op in BRANCHES.values():
            taken = {"beq": a == b, "bne": a != b,
                     "blt": _s32(a) < _s32(b), "bge": _s32(a) >= _s32(b),
                     "bltu": a < b, "bgeu": a >= b}[op]
            if taken:
                npc = (st.pc + ins.imm) & MASK32
        elif op in LOADS.values():
            addr = (a + ins.imm) & MASK32
            wa, off = addr >> 2, addr & 3
            w = ld_word(wa)
            if op == "lw":
                assert off == 0, "misaligned lw"
                val = w
            elif op in ("lb", "lbu"):
                byte = (w >> (8 * off)) & 0xFF
                val = byte if op == "lbu" else _sext(byte, 8) & MASK32
            else:  # lh / lhu
                assert off % 2 == 0, "misaligned lh"
                half = (w >> (8 * off)) & 0xFFFF
                val = half if op == "lhu" else _sext(half, 16) & MASK32
            mem_op = (wa, w, w, 0)
        elif op in STORES.values():
            addr = (a + ins.imm) & MASK32
            wa, off = addr >> 2, addr & 3
            old = ld_word(wa)
            if op == "sw":
                assert off == 0, "misaligned sw"
                new = b
            elif op == "sb":
                sh = 8 * off
                new = (old & ~(0xFF << sh)) | ((b & 0xFF) << sh)
            else:  # sh
                assert off % 2 == 0, "misaligned sh"
                sh = 8 * off
                new = (old & ~(0xFFFF << sh)) | ((b & 0xFFFF) << sh)
            mem[wa] = new
            mem_op = (wa, old, new, 1)
        elif op == "fence":
            pass
        if val is not None and ins.rd != 0:
            regs[ins.rd] = val
        st.pc = npc
        states.append(RvState(st.pc, list(regs), st.halted, mem_op=mem_op))
    return states, st


def load_elf(path: str):
    """Load an RV32 ELF: returns (program dict pc->RvInstr, entry,
    image dict word_addr->word).  Thin compatibility shim over
    zkvm/elf.py (the full loader, incl. the prove pipeline glue)."""
    from .elf import load_elf as _load

    program, entry, image0, _, mem_base = _load(path)
    image = {} if image0 is None else \
        {mem_base + i: int(w) for i, w in enumerate(image0) if w}
    return program, entry, image
