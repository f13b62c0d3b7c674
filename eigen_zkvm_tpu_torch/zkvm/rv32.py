"""RV32IM arithmetization: machine PIL + trace generation for REAL RISC-V
machine code (decoded by zkvm/rv32_isa.py from raw words or a compiled ELF).

The native replacement for the reference's powdr RISC-V pipeline
(zkvm/src/lib.rs:172 compile_rust -> powdr-asm -> PIL).  Design follows
zkvm/machine.py (one row per cycle, whole-column vectorized proving) grown
to the full unprivileged RV32IM spec:

  - 32 registers (x0 pinned to 0), one-hot operand binding against a
    constant ROM keyed by BYTE pc
  - byte-addressed loads/stores: lb/lbu/lh/lhu are single-cycle word reads
    with in-constraint byte/half extraction; sb/sh expand to TWO trace rows
    (read-modify-write micro-cycles, pc stalled via a phase column) so the
    address/step-sorted memory argument sees a plain read then write
  - shifts by computed 2^sh (bit-decomposed shamt, product chain), with
    remainder/overflow windows range-pinned by complement checks r+c=2^sh-1
  - signed compare/div/rem/mulh built from unsigned cores + sign-bit
    columns extracted from operand byte decompositions
  - div/rem follow the spec (div-by-zero and MIN_INT/-1 cases included)
  - memory continuations (RAM image digests) reuse zkvm/continuations.py

Inputs are delivered through the initial RAM image (and registers a0/a1 at
entry); ecall halts.  All identities stay <= degree 2.

Copy of eigen_zkvm_tpu/zkvm/rv32.py for the PyTorch port, imports
pointed at the port.
"""
from __future__ import annotations

import numpy as np

from ..ops import gl
from ..stark.pil_builder import PilBuilder
from ..stark.polsarray import PolsArray
from . import continuations
from .rv32_isa import ALL_OPS, BRANCHES, LOADS, RvInstr, STORES, WORD

MASK32 = WORD - 1
P_INT = gl.P_INT
N_REGS = 32

R_FORM = {"add", "sub", "sll", "slt", "sltu", "xor", "srl", "sra", "or",
          "and", "mul", "mulh", "mulhsu", "mulhu", "div", "divu", "rem",
          "remu"}
I_FORM = {"addi", "slti", "sltiu", "xori", "ori", "andi", "slli", "srli",
          "srai"}
SHIFTS = {"sll", "srl", "sra", "slli", "srli", "srai"}
RIGHT_SHIFTS = {"srl", "sra", "srli", "srai"}
LEFT_SHIFTS = {"sll", "slli"}
BITWISE = {"and", "or", "xor", "andi", "ori", "xori"}
DIV_CLASS = {"div", "divu", "rem", "remu"}
MEM_OPS = set(LOADS.values()) | set(STORES.values())
TWO_CYCLE = {"sb", "sh"}
WRITES_RD = (R_FORM | I_FORM | set(LOADS.values())
             | {"lui", "auipc", "jal", "jalr"})


def _s32i(v: int) -> int:
    return v - WORD if v & 0x80000000 else v


def _alu_result(op: str, ins: RvInstr, a: int, b: int, arg2: int,
                pc: int) -> int:
    """The register value `op` would write — RV32IM semantics over the
    already-selected second operand (rs2 or imm).  Used to fill rdv on
    frozen skip rows so the selector-gated ALU identities hold without
    executing the instruction (rv32_isa.execute is the live counterpart)."""
    if op in ("add", "addi"):
        return (a + arg2) & MASK32
    if op == "sub":
        return (a - b) & MASK32
    if op in ("and", "andi"):
        return a & arg2
    if op in ("or", "ori"):
        return a | arg2
    if op in ("xor", "xori"):
        return a ^ arg2
    if op in ("sll", "slli"):
        return (a << ((b if op == "sll" else ins.imm) & 31)) & MASK32
    if op in ("srl", "srli"):
        return a >> ((b if op == "srl" else ins.imm) & 31)
    if op in ("sra", "srai"):
        return (_s32i(a) >> ((b if op == "sra" else ins.imm) & 31)) & MASK32
    if op in ("slt", "slti"):
        return 1 if _s32i(a) < _s32i(arg2) else 0
    if op in ("sltu", "sltiu"):
        return 1 if a < arg2 else 0
    if op == "mul":
        return (a * b) & MASK32
    if op == "mulhu":
        return (a * b) >> 32
    if op == "mulh":
        return ((_s32i(a) * _s32i(b)) >> 32) & MASK32
    if op == "mulhsu":
        return ((_s32i(a) * b) >> 32) & MASK32
    if op in ("divu", "remu"):
        if b == 0:
            return MASK32 if op == "divu" else a
        return a // b if op == "divu" else a % b
    if op in ("div", "rem"):
        sa, sb = _s32i(a), _s32i(b)
        if b == 0:
            return MASK32 if op == "div" else a
        if sa == -(1 << 31) and sb == -1:
            return a if op == "div" else 0
        q = abs(sa) // abs(sb)
        if (sa < 0) != (sb < 0):
            q = -q
        return (q if op == "div" else sa - q * sb) & MASK32
    if op == "lui":
        return ins.imm & MASK32
    if op == "auipc":
        return (pc + ins.imm) & MASK32
    return 0


def _sgn_to_field(v: int) -> int:
    """Store a (possibly negative) pc-relative offset as a field element."""
    return v % P_INT


class Rv32Machine:
    NS = "Rv32"

    def __init__(self, program: dict[int, RvInstr], n_bits: int = 12,
                 ram_words: int | None = None, mem_base: int = 0):
        self.program = dict(program)
        self.n_bits = n_bits
        assert n_bits <= 16, "step-difference range checks use 2 bytes"
        self.N = 1 << n_bits
        assert len(program) <= self.N
        self.ram_words = ram_words
        # word-address origin of the RAM image: linker-chosen base vaddrs
        # (0x10000 ld default, 0x80000000 embedded) map to image index 0,
        # so the image covers min..max loaded addresses instead of 0..max
        # (the in-circuit relation addrb = 4*(wa + mem_base) + off makes
        # the shift sound — wa is the committed column, mem_base a machine
        # constant baked into the constraint)
        assert mem_base % 8 == 0, "mem_base must be 8-word aligned"
        assert 0 <= mem_base < (1 << 30), "mem_base is a 32-bit word address"
        self.mem_base = mem_base
        self.continuations = ram_words is not None
        if self.continuations:
            assert ram_words % 8 == 0
            assert continuations.rows_needed(ram_words) + 1 < self.N, \
                "ram_words too large for this chunk size"
        self.has_bitwise = True  # nibble table always present (andi etc.)
        assert self.N >= 1024, "rv32 machine needs the 768-row nibble table"
        self._build_pil()

    # ------------------------------------------------------------------
    def _build_pil(self):
        p = PilBuilder(self.n_bits)
        self.p = p
        N = self.N
        NOPS = len(ALL_OPS)

        # ---- constants ----
        self.c_l1 = p.const_pol("Global.L1")
        self.c_llast = p.const_pol("Rv32.LLAST")
        self.c_byte = p.const_pol("Rv32.BYTE")
        self.c_line = p.const_pol("Rv32.LINE")
        self.c_rom_on = p.const_pol("Rv32.ROM_ON")
        self.c_rom_pc = p.const_pol("Rv32.ROM_PC")
        self.c_rom_sel = p.const_pol("Rv32.ROM_SEL", NOPS)
        self.c_rom_imm = p.const_pol("Rv32.ROM_IMM")
        self.c_rom_rd = p.const_pol("Rv32.ROM_RD", N_REGS)
        self.c_rom_rs1 = p.const_pol("Rv32.ROM_RS1", N_REGS)
        self.c_rom_rs2 = p.const_pol("Rv32.ROM_RS2", N_REGS)
        self.c_nib_on = p.const_pol("Rv32.NIB_ON")
        self.c_nib_tag = p.const_pol("Rv32.NIB_TAG")
        self.c_nib_a = p.const_pol("Rv32.NIB_A")
        self.c_nib_b = p.const_pol("Rv32.NIB_B")
        self.c_nib_out = p.const_pol("Rv32.NIB_OUT")
        if self.continuations:
            continuations.declare_consts(self, p)

        # ---- commits ----
        self.m_pc = p.cm_pol("Rv32.pc")
        self.m_ph = p.cm_pol("Rv32.ph")
        self.m_skip = p.cm_pol("Rv32.skip")  # trailing no-exec pad rows
        self.m_x = p.cm_pol("Rv32.x", N_REGS)
        self.m_sel = p.cm_pol("Rv32.sel", NOPS)
        self.m_imm = p.cm_pol("Rv32.imm")
        self.m_rd1h = p.cm_pol("Rv32.rd1h", N_REGS)
        self.m_rs11h = p.cm_pol("Rv32.rs11h", N_REGS)
        self.m_rs21h = p.cm_pol("Rv32.rs21h", N_REGS)
        self.m_rs1v = p.cm_pol("Rv32.rs1v")
        self.m_rs2v = p.cm_pol("Rv32.rs2v")
        self.m_rdv = p.cm_pol("Rv32.rdv")
        self.m_bytes_rd = p.cm_pol("Rv32.bytes_rd", 4)
        self.m_bytes_rs1 = p.cm_pol("Rv32.bytes_rs1", 4)
        self.m_bytes_rs2 = p.cm_pol("Rv32.bytes_rs2", 4)
        self.m_a7l = p.cm_pol("Rv32.a7l")      # rs1 top byte = a7l + 128*a31
        self.m_a31 = p.cm_pol("Rv32.a31")
        self.m_b7l = p.cm_pol("Rv32.b7l")
        self.m_b31 = p.cm_pol("Rv32.b31")
        self.m_carry = p.cm_pol("Rv32.carry")
        self.m_arg2 = p.cm_pol("Rv32.arg2")    # rs2v (R) / imm (I)
        # multiply core: rs1v*rs2v = mlo + 2^32*mhi
        self.m_mlo = p.cm_pol("Rv32.mlo")
        self.m_mhi = p.cm_pol("Rv32.mhi")
        self.m_bytes_mlo = p.cm_pol("Rv32.bytes_mlo", 4)
        self.m_bytes_mhi = p.cm_pol("Rv32.bytes_mhi", 4)
        self.m_k0 = p.cm_pol("Rv32.k0")        # signed-high adjust bits
        self.m_k1 = p.cm_pol("Rv32.k1")
        # equality / compare helpers
        self.m_iz = p.cm_pol("Rv32.iz")        # rs1v == arg2
        self.m_dinv = p.cm_pol("Rv32.dinv")
        self.m_izb = p.cm_pol("Rv32.izb")      # rs2v == 0 (div)
        self.m_dinvb = p.cm_pol("Rv32.dinvb")
        self.m_lt = p.cm_pol("Rv32.lt")        # unsigned rs1v < arg2
        self.m_bytes_lt = p.cm_pol("Rv32.bytes_lt", 4)
        self.m_lts = p.cm_pol("Rv32.lts")      # signed rs1v < arg2
        self.m_bytes_lts = p.cm_pol("Rv32.bytes_lts", 4)
        self.m_i31 = p.cm_pol("Rv32.i31")      # sign bit of arg2
        self.m_i7l = p.cm_pol("Rv32.i7l")
        self.m_bytes_arg2 = p.cm_pol("Rv32.bytes_arg2", 4)
        # bitwise nibbles
        self.m_na = p.cm_pol("Rv32.na", 8)
        self.m_nb = p.cm_pol("Rv32.nb", 8)
        self.m_no = p.cm_pol("Rv32.no", 8)
        # shift core
        self.m_shb = p.cm_pol("Rv32.shb", 5)   # shamt bits
        self.m_qsh = p.cm_pol("Rv32.qsh")      # rs2v = 32*qsh + sh
        self.m_bytes_qsh = p.cm_pol("Rv32.bytes_qsh", 4)
        self.m_p2c = p.cm_pol("Rv32.p2c")      # 2^(32-sh)
        self.m_shq = p.cm_pol("Rv32.shq")      # right-shift quotient
        self.m_bytes_shq = p.cm_pol("Rv32.bytes_shq", 4)
        self.m_shr = p.cm_pol("Rv32.shr")      # remainder / left overflow
        self.m_bytes_shr = p.cm_pol("Rv32.bytes_shr", 4)
        self.m_shc = p.cm_pol("Rv32.shc")      # complement: shr+shc = p2-1
        self.m_bytes_shc = p.cm_pol("Rv32.bytes_shc", 4)
        # divider core
        self.m_qm = p.cm_pol("Rv32.qm")
        self.m_bytes_qm = p.cm_pol("Rv32.bytes_qm", 4)
        self.m_rm = p.cm_pol("Rv32.rm")
        self.m_bytes_rm = p.cm_pol("Rv32.bytes_rm", 4)
        self.m_ltd = p.cm_pol("Rv32.ltd")      # rm < |b|
        self.m_bytes_ltd = p.cm_pol("Rv32.bytes_ltd", 4)
        self.m_izq = p.cm_pol("Rv32.izq")      # qm == 0
        self.m_dinvq = p.cm_pol("Rv32.dinvq")
        self.m_izr = p.cm_pol("Rv32.izr")      # rm == 0
        self.m_dinvr = p.cm_pol("Rv32.dinvr")
        # jalr target
        self.m_jw = p.cm_pol("Rv32.jw")        # 2^32 wrap bit
        self.m_j0 = p.cm_pol("Rv32.j0")        # dropped lsb
        self.m_jhalf = p.cm_pol("Rv32.jhalf")
        self.m_bytes_jh = p.cm_pol("Rv32.bytes_jh", 4)
        # memory
        self.m_addrb = p.cm_pol("Rv32.addrb")  # byte address
        self.m_ac = p.cm_pol("Rv32.ac")
        self.m_bytes_addr = p.cm_pol("Rv32.bytes_addr", 4)
        self.m_addr = p.cm_pol("Rv32.wa")      # word address (image space)
        self.m_bytes_wa = p.cm_pol("Rv32.bytes_wa", 4)
        self.m_o0 = p.cm_pol("Rv32.o0")
        self.m_o1 = p.cm_pol("Rv32.o1")
        self.m_mwold = p.cm_pol("Rv32.mwold")
        self.m_bytes_mw = p.cm_pol("Rv32.bytes_mw", 4)
        self.m_mwnew = p.cm_pol("Rv32.mwnew")
        self.m_lbl = p.cm_pol("Rv32.lbl")      # load byte low7
        self.m_lb7 = p.cm_pol("Rv32.lb7")      # load byte sign
        self.m_lhl = p.cm_pol("Rv32.lhl")      # load half low15 top7
        self.m_lh15 = p.cm_pol("Rv32.lh15")    # load half sign
        # sorted memory side
        self.s_on = p.cm_pol("Rv32.s_on")
        self.s_addr = p.cm_pol("Rv32.s_addr")
        self.s_step = p.cm_pol("Rv32.s_step")
        self.s_val = p.cm_pol("Rv32.s_val")
        self.s_iswr = p.cm_pol("Rv32.s_iswr")
        self.s_same = p.cm_pol("Rv32.s_same")
        self.s_dinv = p.cm_pol("Rv32.s_dinv")
        self.s_bytes_sd = p.cm_pol("Rv32.s_bytes_sd", 2)
        self.s_bytes_ad = p.cm_pol("Rv32.s_bytes_ad", 4)
        if self.continuations:
            continuations.declare_commits(self, p)

        # ---- shorthand ----
        sel = {op: p.cm(self.m_sel + i) for i, op in enumerate(ALL_OPS)}
        self._sel = sel
        cm, const, num = p.cm, p.const, p.num
        x = [cm(self.m_x + i) for i in range(N_REGS)]
        xp = [cm(self.m_x + i, True) for i in range(N_REGS)]
        pc, pcp = cm(self.m_pc), cm(self.m_pc, True)
        ph, php = cm(self.m_ph), cm(self.m_ph, True)
        rs1v, rs2v, rdv = cm(self.m_rs1v), cm(self.m_rs2v), cm(self.m_rdv)
        imm, arg2 = cm(self.m_imm), cm(self.m_arg2)
        llast = const(self.c_llast)
        not_last = p.sub(num(1), llast)
        W32 = 1 << 32

        def s_of(ops):
            return p.lin([(1, sel[o]) for o in sorted(ops)])

        def bool_col(c):
            p.identity(p.mul(c, p.sub(num(1), c)), "rv32.pil", 1)

        def byte_rng(base, n):
            for k in range(n):
                p.plookup(f=[cm(base + k)], t=[const(self.c_byte)],
                          file_name="rv32.pil", line=2)

        def bind_bytes(val, base, n=4):
            p.identity(p.sub(val, p.lin([(1 << (8 * k), cm(base + k))
                                         for k in range(n)])), "rv32.pil", 3)
            byte_rng(base, n)

        # ---- fetch ----
        f = [pc] + [sel[o] for o in ALL_OPS] + [imm]
        t = [const(self.c_rom_pc)] + \
            [const(self.c_rom_sel + i) for i in range(NOPS)] + \
            [const(self.c_rom_imm)]
        for base_c, base_m in ((self.c_rom_rd, self.m_rd1h),
                               (self.c_rom_rs1, self.m_rs11h),
                               (self.c_rom_rs2, self.m_rs21h)):
            f += [cm(base_m + i) for i in range(N_REGS)]
            t += [const(base_c + i) for i in range(N_REGS)]
        p.plookup(f=f, t=t, sel_f=None, sel_t=const(self.c_rom_on),
                  file_name="rv32.pil", line=4)

        # ---- operand binding ----
        p.identity(p.sub(rs1v, p.lin(
            [(1, p.mul(cm(self.m_rs11h + i), x[i])) for i in range(N_REGS)])),
            "rv32.pil", 5)
        p.identity(p.sub(rs2v, p.lin(
            [(1, p.mul(cm(self.m_rs21h + i), x[i])) for i in range(N_REGS)])),
            "rv32.pil", 6)
        p.identity(x[0], "rv32.pil", 7)

        # arg2 = rs2v on R-form/branch rows, imm otherwise
        is_r2 = s_of(R_FORM | set(BRANCHES.values()))
        im_r2 = p.intermediate(p.mul(is_r2, p.sub(rs2v, imm)))
        p.identity(p.sub(arg2, p.add(imm, im_r2)), "rv32.pil", 8)

        # operand / result ranges + sign-bit splits.  arg2 is only bound to
        # its byte decomposition on compare rows: on jal/branch rows the imm
        # is a signed-mod-p pc offset, not a 32-bit value (its 32-bit-ness
        # on compare rows follows from arg2 = rs2v (ranged) or a trusted
        # ROM constant).
        is_scmp = s_of({"slt", "slti", "blt", "bge"})
        is_ucmp = s_of({"sltu", "sltiu", "bltu", "bgeu"})
        bind_bytes(rdv, self.m_bytes_rd)
        bind_bytes(rs1v, self.m_bytes_rs1)
        bind_bytes(rs2v, self.m_bytes_rs2)
        byte_rng(self.m_bytes_arg2, 4)
        p.identity(p.mul(is_scmp, p.sub(arg2, p.lin(
            [(1 << (8 * k), cm(self.m_bytes_arg2 + k)) for k in range(4)]))),
            "rv32.pil", 8)
        for top, low, bit in ((self.m_bytes_rs1 + 3, self.m_a7l, self.m_a31),
                              (self.m_bytes_rs2 + 3, self.m_b7l, self.m_b31),
                              (self.m_bytes_arg2 + 3, self.m_i7l, self.m_i31)):
            bool_col(cm(bit))
            p.identity(p.sub(cm(top), p.add(cm(low), p.smul(128, cm(bit)))),
                       "rv32.pil", 9)
            p.plookup(f=[p.smul(2, cm(low))], t=[const(self.c_byte)],
                      file_name="rv32.pil", line=9)
        a31, b31, i31 = cm(self.m_a31), cm(self.m_b31), cm(self.m_i31)

        # ---- register updates (x0 write-protected by rom rd one-hot) ----
        # `skip` marks trailing pad rows of a non-final chunk (the 2-row
        # stores make exact-N row counts unreachable in general): once
        # raised it stays raised, and the machine state freezes, so the
        # boundary publics still carry the hand-off state.  A prover may
        # only UNDER-execute a chunk with it — the chain stays valid.
        skip = cm(self.m_skip)
        bool_col(skip)
        im_skmono = p.intermediate(p.mul(skip, p.sub(num(1),
                                                     cm(self.m_skip, True))))
        p.identity(p.mul(not_last, im_skmono), "rv32.pil", 10)
        nskip = p.sub(num(1), skip)
        for i in range(N_REGS):
            wr = p.intermediate(p.mul(cm(self.m_rd1h + i), p.sub(rdv, x[i])))
            wr = p.intermediate(p.mul(nskip, wr))
            p.identity(p.mul(not_last, p.sub(p.sub(xp[i], x[i]), wr)),
                       "rv32.pil", 10)

        # ---- ALU: add/sub family ----
        carry = cm(self.m_carry)
        bool_col(carry)
        p.identity(p.mul(p.add(sel["add"], sel["addi"]),
                         p.sub(p.add(rs1v, arg2),
                               p.add(rdv, p.smul(W32, carry)))), "rv32.pil", 11)
        p.identity(p.mul(sel["sub"], p.sub(p.add(rs1v, p.smul(W32, carry)),
                                           p.add(arg2, rdv))), "rv32.pil", 12)
        p.identity(p.mul(sel["lui"], p.sub(rdv, imm)), "rv32.pil", 13)
        p.identity(p.mul(sel["auipc"],
                         p.sub(p.add(pc, imm),
                               p.add(rdv, p.smul(W32, carry)))), "rv32.pil", 14)
        p.identity(p.mul(p.add(sel["jal"], sel["jalr"]),
                         p.sub(rdv, p.add(pc, num(4)))), "rv32.pil", 15)

        # ---- multiply core: rs1v * rs2v = mlo + 2^32 * mhi ----
        mlo, mhi = cm(self.m_mlo), cm(self.m_mhi)
        bind_bytes(mlo, self.m_bytes_mlo)
        bind_bytes(mhi, self.m_bytes_mhi)
        prod = p.intermediate(p.mul(rs1v, rs2v))
        is_mul = s_of({"mul", "mulh", "mulhu", "mulhsu"})
        p.identity(p.mul(is_mul, p.sub(prod, p.add(mlo, p.smul(W32, mhi)))),
                   "rv32.pil", 16)
        p.identity(p.mul(sel["mul"], p.sub(rdv, mlo)), "rv32.pil", 17)
        p.identity(p.mul(sel["mulhu"], p.sub(rdv, mhi)), "rv32.pil", 18)
        k0, k1 = cm(self.m_k0), cm(self.m_k1)
        bool_col(k0)
        bool_col(k1)
        im_ab = p.intermediate(p.mul(a31, b31))
        im_a_b2 = p.intermediate(p.mul(a31, rs2v))
        im_b_a2 = p.intermediate(p.mul(b31, rs1v))
        # mulh: rdv = mhi - a31*b - b31*a + a31*b31*2^32 + 2^33 - k*2^32
        p.identity(p.mul(sel["mulh"], p.sub(
            p.lin([(1, mhi), (P_INT - 1, im_a_b2), (P_INT - 1, im_b_a2),
                   (W32, im_ab), (2 * W32, num(1))]),
            p.add(rdv, p.lin([(W32, k0), (2 * W32, k1)])))), "rv32.pil", 19)
        # mulhsu: rdv = mhi - a31*b + 2^32 - k0*2^32
        p.identity(p.mul(sel["mulhsu"], p.sub(
            p.lin([(1, mhi), (P_INT - 1, im_a_b2), (W32, num(1))]),
            p.add(rdv, p.smul(W32, k0)))), "rv32.pil", 20)

        # ---- equality / compares ----
        iz, dinv = cm(self.m_iz), cm(self.m_dinv)
        diff = p.sub(rs1v, arg2)
        p.identity(p.mul(iz, diff), "rv32.pil", 21)
        p.identity(p.sub(p.add(iz, p.mul(diff, dinv)), num(1)), "rv32.pil", 21)
        izb, dinvb = cm(self.m_izb), cm(self.m_dinvb)
        p.identity(p.mul(izb, rs2v), "rv32.pil", 22)
        p.identity(p.sub(p.add(izb, p.mul(rs2v, dinvb)), num(1)),
                   "rv32.pil", 22)

        def ltu_gadget(a_expr, b_expr, lt_col, bytes_base, line, gate=None):
            """lt_col <- [a < b] with a 4-byte borrow window.  `gate`
            restricts the equation to rows where both operands are known
            32-bit (compare selectors); ungated gadgets must be satisfiable
            on every row."""
            lt_ = cm(lt_col)
            bool_col(lt_)
            lb = p.lin([(1 << (8 * k), cm(bytes_base + k)) for k in range(4)])
            byte_rng(bytes_base, 4)
            eq = p.sub(p.add(p.sub(a_expr, b_expr), num(W32)),
                       p.add(p.mul(p.sub(num(1), lt_), num(W32)), lb))
            if gate is not None:
                eq = p.mul(gate, p.intermediate(eq)) \
                    if eq.deg > 1 else p.mul(gate, eq)
            p.identity(eq, "rv32.pil", line)
            return lt_

        lt = ltu_gadget(rs1v, arg2, self.m_lt, self.m_bytes_lt, 23,
                        gate=is_ucmp)
        # signed: flip both operands by +2^31(1-2*sign)
        af = p.intermediate(p.add(rs1v, p.smul(1 << 31,
                                               p.sub(num(1), p.smul(2, a31)))))
        bf = p.intermediate(p.add(arg2, p.smul(1 << 31,
                                               p.sub(num(1), p.smul(2, i31)))))
        lts = ltu_gadget(af, bf, self.m_lts, self.m_bytes_lts, 24,
                         gate=is_scmp)
        p.identity(p.mul(p.add(sel["sltu"], sel["sltiu"]), p.sub(rdv, lt)),
                   "rv32.pil", 25)
        p.identity(p.mul(p.add(sel["slt"], sel["slti"]), p.sub(rdv, lts)),
                   "rv32.pil", 26)

        # ---- bitwise via nibble table ----
        is_bw = s_of(BITWISE)
        tag = p.lin([(1, p.add(sel["or"], sel["ori"])),
                     (2, p.add(sel["xor"], sel["xori"]))])
        for val, base in ((rs1v, self.m_na), (arg2, self.m_nb),
                          (rdv, self.m_no)):
            nib = p.lin([(1 << (4 * k), cm(base + k)) for k in range(8)])
            p.identity(p.mul(is_bw, p.sub(val, nib)), "rv32.pil", 27)
        for k in range(8):
            p.plookup(f=[tag, cm(self.m_na + k), cm(self.m_nb + k),
                         cm(self.m_no + k)],
                      t=[const(self.c_nib_tag), const(self.c_nib_a),
                         const(self.c_nib_b), const(self.c_nib_out)],
                      sel_f=is_bw, sel_t=const(self.c_nib_on),
                      file_name="rv32.pil", line=28)

        # ---- shifts ----
        shb = [cm(self.m_shb + k) for k in range(5)]
        for b in shb:
            bool_col(b)
        sh = p.lin([(1 << k, shb[k]) for k in range(5)])
        is_shift = s_of(SHIFTS)
        is_shift_r = s_of({"sll", "srl", "sra"})
        is_shift_i = s_of({"slli", "srli", "srai"})
        qsh = cm(self.m_qsh)
        bind_bytes(qsh, self.m_bytes_qsh)
        p.identity(p.mul(is_shift_r,
                         p.sub(rs2v, p.add(p.smul(32, qsh), sh))),
                   "rv32.pil", 29)
        p.identity(p.mul(is_shift_i, p.sub(sh, imm)), "rv32.pil", 30)
        # p2 = 2^sh as a product chain over the shamt bits
        p2 = p.intermediate(p.mul(p.add(num(1), shb[0]),
                                  p.add(num(1), p.smul(3, shb[1]))))
        p2 = p.intermediate(p.mul(p2, p.add(num(1), p.smul(15, shb[2]))))
        p2 = p.intermediate(p.mul(p2, p.add(num(1), p.smul(255, shb[3]))))
        p2 = p.intermediate(p.mul(p2, p.add(num(1), p.smul(65535, shb[4]))))
        p2c = cm(self.m_p2c)
        p.identity(p.mul(is_shift,
                         p.sub(p.mul(p2, p2c), num(W32))), "rv32.pil", 31)
        shq, shr, shc = cm(self.m_shq), cm(self.m_shr), cm(self.m_shc)
        bind_bytes(shq, self.m_bytes_shq)
        bind_bytes(shr, self.m_bytes_shr)
        bind_bytes(shc, self.m_bytes_shc)
        # window pin: shr + shc = p2 - 1 (exact in Z: all three 32-bit)
        p.identity(p.mul(is_shift,
                         p.sub(p.add(shr, shc), p.sub(p2, num(1)))),
                   "rv32.pil", 32)
        im_qp2 = p.intermediate(p.mul(shq, p2))
        p.identity(p.mul(s_of(RIGHT_SHIFTS),
                         p.sub(rs1v, p.add(im_qp2, shr))), "rv32.pil", 33)
        p.identity(p.mul(p.add(sel["srl"], sel["srli"]), p.sub(rdv, shq)),
                   "rv32.pil", 34)
        im_fill = p.intermediate(p.mul(a31, p.sub(num(W32), p2c)))
        p.identity(p.mul(p.add(sel["sra"], sel["srai"]),
                         p.sub(rdv, p.add(shq, im_fill))), "rv32.pil", 35)
        im_ap2 = p.intermediate(p.mul(rs1v, p2))
        p.identity(p.mul(s_of(LEFT_SHIFTS),
                         p.sub(im_ap2, p.add(p.smul(W32, shr), rdv))),
                   "rv32.pil", 36)

        # ---- divider ----
        is_div = s_of(DIV_CLASS)
        is_udiv = p.add(sel["divu"], sel["remu"])
        is_sdiv = p.add(sel["div"], sel["rem"])
        # magnitudes (signed forms) / raw operands (unsigned forms)
        im_ma = p.intermediate(p.add(rs1v, p.mul(
            is_sdiv, p.mul(a31, p.sub(num(W32), p.smul(2, rs1v))))))
        im_mb = p.intermediate(p.add(rs2v, p.mul(
            is_sdiv, p.mul(b31, p.sub(num(W32), p.smul(2, rs2v))))))
        qm, rm = cm(self.m_qm), cm(self.m_rm)
        bind_bytes(qm, self.m_bytes_qm)
        bind_bytes(rm, self.m_bytes_rm)
        im_qmb = p.intermediate(p.mul(qm, im_mb))
        p.identity(p.mul(is_div, p.sub(im_ma, p.add(im_qmb, rm))),
                   "rv32.pil", 37)
        ltd = ltu_gadget(rm, im_mb, self.m_ltd, self.m_bytes_ltd, 38)
        im_div_nz = p.intermediate(p.mul(is_div, p.sub(num(1), izb)))
        p.identity(p.mul(im_div_nz, p.sub(num(1), ltd)), "rv32.pil", 39)
        # zero-divisor defaults: q = 2^32-1, r = a
        izq, dinvq = cm(self.m_izq), cm(self.m_dinvq)
        p.identity(p.mul(izq, qm), "rv32.pil", 40)
        p.identity(p.sub(p.add(izq, p.mul(qm, dinvq)), num(1)), "rv32.pil", 40)
        izr, dinvr = cm(self.m_izr), cm(self.m_dinvr)
        p.identity(p.mul(izr, rm), "rv32.pil", 41)
        p.identity(p.sub(p.add(izr, p.mul(rm, dinvr)), num(1)), "rv32.pil", 41)
        im_qsign = p.intermediate(p.add(a31, p.sub(b31, p.smul(2, im_ab))))
        im_negq = p.intermediate(p.mul(p.sub(num(W32), qm),
                                       p.sub(num(1), izq)))
        im_negr = p.intermediate(p.mul(p.sub(num(W32), rm),
                                       p.sub(num(1), izr)))
        # divu: rdv = (1-izb)*qm + izb*(2^32-1)
        im_t = p.intermediate(p.mul(p.sub(num(1), izb), qm))
        p.identity(p.mul(sel["divu"], p.sub(rdv, p.add(
            im_t, p.smul(MASK32, izb)))), "rv32.pil", 42)
        im_t = p.intermediate(p.mul(p.sub(num(1), izb), rm))
        p.identity(p.mul(sel["remu"], p.sub(rdv, p.add(
            im_t, p.mul(izb, rs1v)))), "rv32.pil", 43)
        # div: signed quotient with truncation
        im_qs = p.intermediate(p.add(
            p.mul(p.sub(num(1), im_qsign), qm),
            p.mul(im_qsign, im_negq)))
        im_t = p.intermediate(p.mul(p.sub(num(1), izb), im_qs))
        p.identity(p.mul(sel["div"], p.sub(rdv, p.add(
            im_t, p.smul(MASK32, izb)))), "rv32.pil", 44)
        # rem: sign follows the dividend
        im_rs = p.intermediate(p.add(p.mul(p.sub(num(1), a31), rm),
                                     p.mul(a31, im_negr)))
        im_t = p.intermediate(p.mul(p.sub(num(1), izb), im_rs))
        p.identity(p.mul(sel["rem"], p.sub(rdv, p.add(
            im_t, p.mul(izb, rs1v)))), "rv32.pil", 45)

        # ---- memory ----
        is_load = s_of(set(LOADS.values()))
        is_store = s_of(set(STORES.values()))
        is_mem = p.add(is_load, is_store)
        self._is_mem = is_mem
        addrb, ac = cm(self.m_addrb), cm(self.m_ac)
        bool_col(ac)
        bind_bytes(addrb, self.m_bytes_addr)
        p.identity(p.mul(is_mem, p.sub(p.add(rs1v, imm),
                                       p.add(addrb, p.smul(W32, ac)))),
                   "rv32.pil", 46)
        wa = cm(self.m_addr)
        bind_bytes(wa, self.m_bytes_wa)
        o0, o1 = cm(self.m_o0), cm(self.m_o1)
        bool_col(o0)
        bool_col(o1)
        p.identity(p.mul(is_mem, p.sub(addrb, p.add(p.lin(
            [(4, wa), (1, o0), (2, o1)]),
            p.num(4 * self.mem_base)))), "rv32.pil", 47)
        # alignment
        p.identity(p.mul(p.lin([(1, sel["lw"]), (1, sel["sw"]),
                                (1, sel["lh"]), (1, sel["lhu"]),
                                (1, sel["sh"])]), o0), "rv32.pil", 48)
        p.identity(p.mul(p.add(sel["lw"], sel["sw"]), o1), "rv32.pil", 48)

        mwold, mwnew = cm(self.m_mwold), cm(self.m_mwnew)
        bind_bytes(mwold, self.m_bytes_mw)
        mb = [cm(self.m_bytes_mw + k) for k in range(4)]
        # byte/half extraction from the read word
        im_oh0 = p.intermediate(p.mul(p.sub(num(1), o0), p.sub(num(1), o1)))
        im_oh1 = p.intermediate(p.mul(o0, p.sub(num(1), o1)))
        im_oh2 = p.intermediate(p.mul(p.sub(num(1), o0), o1))
        im_oh3 = p.intermediate(p.mul(o0, o1))
        im_byte = p.intermediate(p.lin([
            (1, p.mul(im_oh0, mb[0])), (1, p.mul(im_oh1, mb[1])),
            (1, p.mul(im_oh2, mb[2])), (1, p.mul(im_oh3, mb[3]))]))
        lbl, lb7 = cm(self.m_lbl), cm(self.m_lb7)
        bool_col(lb7)
        p.plookup(f=[p.smul(2, lbl)], t=[const(self.c_byte)],
                  file_name="rv32.pil", line=49)
        is_byte_ld = p.add(sel["lb"], sel["lbu"])
        p.identity(p.mul(is_byte_ld,
                         p.sub(im_byte, p.add(lbl, p.smul(128, lb7)))),
                   "rv32.pil", 49)
        p.identity(p.mul(sel["lbu"], p.sub(rdv, im_byte)), "rv32.pil", 50)
        p.identity(p.mul(sel["lb"], p.sub(rdv, p.add(
            im_byte, p.smul(W32 - 256, lb7)))), "rv32.pil", 51)
        im_half = p.intermediate(p.add(
            p.mul(p.sub(num(1), o1), p.lin([(1, mb[0]), (256, mb[1])])),
            p.mul(o1, p.lin([(1, mb[2]), (256, mb[3])]))))
        lhl, lh15 = cm(self.m_lhl), cm(self.m_lh15)
        bool_col(lh15)
        p.plookup(f=[p.smul(2, lhl)], t=[const(self.c_byte)],
                  file_name="rv32.pil", line=52)
        is_half_ld = p.add(sel["lh"], sel["lhu"])
        # half = lowbyte + 256*(lhl + 128*lh15) — pin the top byte's split
        im_hb = p.intermediate(p.add(
            p.mul(p.sub(num(1), o1), mb[1]), p.mul(o1, mb[3])))
        p.identity(p.mul(is_half_ld,
                         p.sub(im_hb, p.add(lhl, p.smul(128, lh15)))),
                   "rv32.pil", 52)
        p.identity(p.mul(sel["lhu"], p.sub(rdv, im_half)), "rv32.pil", 53)
        p.identity(p.mul(sel["lh"], p.sub(rdv, p.add(
            im_half, p.smul(W32 - 65536, lh15)))), "rv32.pil", 54)
        p.identity(p.mul(sel["lw"], p.sub(rdv, mwold)), "rv32.pil", 55)

        # stores: sw writes rs2v; sb/sh read-modify-write over two rows
        p.identity(p.mul(sel["sw"], p.sub(mwnew, rs2v)), "rv32.pil", 56)
        im_p8 = p.intermediate(p.lin([(1, im_oh0), (256, im_oh1),
                                      (65536, im_oh2), (1 << 24, im_oh3)]))
        im_sbd = p.intermediate(p.mul(p.sub(cm(self.m_bytes_rs2), im_byte),
                                      im_p8))
        p.identity(p.mul(sel["sb"], p.sub(mwnew, p.add(mwold, im_sbd))),
                   "rv32.pil", 57)
        p16 = p.add(num(1), p.smul(65535, o1))
        rs2low16 = p.lin([(1, cm(self.m_bytes_rs2)),
                          (256, cm(self.m_bytes_rs2 + 1))])
        im_shd = p.intermediate(p.mul(p.sub(rs2low16, im_half), p16))
        p.identity(p.mul(sel["sh"], p.sub(mwnew, p.add(mwold, im_shd))),
                   "rv32.pil", 58)

        # ---- two-cycle phase machinery ----
        bool_col(ph)
        is2 = s_of(TWO_CYCLE)
        im_ph0 = p.intermediate(p.mul(is2, p.sub(num(1), ph)))
        im_ph0s = p.intermediate(p.mul(nskip, im_ph0))
        # ph' = !skip & is2 & !ph ; only 2-cycle ops may raise ph
        p.identity(p.mul(not_last, p.sub(php, im_ph0s)), "rv32.pil", 59)
        p.identity(p.mul(ph, p.sub(num(1), is2)), "rv32.pil", 59)
        # the two rows of a store agree on address and words (gated off the
        # wrap row, where next refers to row 0)
        for col in (self.m_addr, self.m_addrb, self.m_mwold, self.m_mwnew):
            im_cp = p.intermediate(p.mul(im_ph0s,
                                         p.sub(cm(col, True), cm(col))))
            p.identity(p.mul(not_last, im_cp), "rv32.pil", 60)

        # memory argument tuple: value is the read word on read rows, the
        # written word on write rows; sw is a pure single-cycle write
        iswr = p.add(sel["sw"], ph)
        im_mval = p.intermediate(p.add(mwold, p.mul(iswr,
                                                    p.sub(mwnew, mwold))))
        im_memsel = p.intermediate(p.mul(nskip, is_mem))
        s_onp = cm(self.s_on, True)
        p.permutation(f=[wa, const(self.c_line), im_mval, iswr],
                      t=[cm(self.s_addr), cm(self.s_step), cm(self.s_val),
                         cm(self.s_iswr)],
                      sel_f=im_memsel, sel_t=cm(self.s_on),
                      file_name="rv32.pil", line=61)

        # sorted-side chronology (same shape as zkvm/machine.py)
        s_on = cm(self.s_on)
        s_addr, s_addrp = cm(self.s_addr), cm(self.s_addr, True)
        s_step, s_stepp = cm(self.s_step), cm(self.s_step, True)
        s_val, s_valp = cm(self.s_val), cm(self.s_val, True)
        s_iswr, s_iswrp = cm(self.s_iswr), cm(self.s_iswr, True)
        s_same = cm(self.s_same)
        for b in (s_on, s_iswr, s_same):
            bool_col(b)
        im_off = p.intermediate(p.mul(s_onp, p.sub(num(1), s_on)))
        p.identity(p.mul(not_last, im_off), "rv32.pil", 62)
        d = p.sub(s_addrp, s_addr)
        im_seg = p.intermediate(p.mul(s_on, s_onp))
        p.identity(p.mul(s_same, d), "rv32.pil", 63)
        im_eq = p.intermediate(p.mul(d, cm(self.s_dinv)))
        p.identity(p.mul(im_seg, p.sub(p.add(s_same, im_eq), num(1))),
                   "rv32.pil", 64)
        im_same = p.intermediate(p.mul(im_seg, s_same))
        self._im_same = im_same
        sd_bytes = p.lin([(1 << (8 * k), cm(self.s_bytes_sd + k))
                          for k in range(2)])
        p.identity(p.mul(im_same,
                         p.sub(p.sub(s_stepp, p.add(s_step, num(1))),
                               sd_bytes)), "rv32.pil", 65)
        im_rd = p.intermediate(p.mul(im_same, p.sub(num(1), s_iswrp)))
        p.identity(p.mul(im_rd, p.sub(s_valp, s_val)), "rv32.pil", 66)
        im_new = p.intermediate(p.mul(im_seg, p.sub(num(1), s_same)))
        im_nw = p.intermediate(p.mul(im_new, p.sub(num(1), s_iswrp)))
        ad_bytes = p.lin([(1 << (8 * k), cm(self.s_bytes_ad + k))
                          for k in range(4)])
        p.identity(p.mul(im_new, p.sub(p.sub(d, num(1)), ad_bytes)),
                   "rv32.pil", 67)
        im_g0 = p.intermediate(p.mul(const(self.c_l1), s_on))
        im_g0w = p.intermediate(p.mul(im_g0, p.sub(num(1), s_iswr)))
        if not self.continuations:
            p.identity(p.mul(im_nw, s_valp), "rv32.pil", 68)
            p.identity(p.mul(im_g0w, s_val), "rv32.pil", 68)
        else:
            img1 = const(self.c_img1_on)
            p.plookup(f=[s_addrp, s_valp],
                      t=[const(self.c_img_addr), cm(self.m_img_w)],
                      sel_f=im_nw, sel_t=img1, file_name="rv32.pil", line=68)
            p.plookup(f=[s_addr, s_val],
                      t=[const(self.c_img_addr), cm(self.m_img_w)],
                      sel_f=im_g0w, sel_t=img1, file_name="rv32.pil", line=68)
        for arr, cnt in ((self.s_bytes_sd, 2), (self.s_bytes_ad, 4)):
            byte_rng(arr, cnt)

        # ---- pc transition ----
        jw, j0, jhalf = cm(self.m_jw), cm(self.m_j0), cm(self.m_jhalf)
        bool_col(jw)
        bool_col(j0)
        bind_bytes(jhalf, self.m_bytes_jh)
        p.identity(p.mul(sel["jalr"], p.sub(
            p.add(rs1v, imm),
            p.lin([(W32, jw), (1, j0), (2, jhalf)]))), "rv32.pil", 69)
        im_taken = p.intermediate(p.lin([
            (1, p.mul(sel["beq"], iz)),
            (1, p.mul(sel["bne"], p.sub(num(1), iz))),
            (1, p.mul(sel["blt"], lts)),
            (1, p.mul(sel["bge"], p.sub(num(1), lts))),
            (1, p.mul(sel["bltu"], lt)),
            (1, p.mul(sel["bgeu"], p.sub(num(1), lt)))]))
        im_delta = p.intermediate(p.lin([
            (1, p.mul(im_taken, p.sub(imm, num(4)))),
            (1, p.mul(sel["jal"], p.sub(imm, num(4)))),
            (1, p.mul(sel["jalr"],
                      p.sub(p.smul(2, jhalf), p.add(pc, num(4))))),
            (P_INT - 4, sel["ecall"])]))
        im_adv = p.intermediate(p.mul(p.sub(num(1), im_ph0),
                                      p.add(num(4), im_delta)))
        im_adv = p.intermediate(p.mul(nskip, im_adv))
        p.identity(p.mul(not_last, p.sub(pcp, p.add(pc, im_adv))),
                   "rv32.pil", 70)

        # ---- continuations ----
        if self.continuations:
            continuations.build(self, p, not_last, llast)

        # ---- boundary publics ----
        l1 = const(self.c_l1)
        binds = [("pc_in", self.m_pc, 0), ("pc_out", self.m_pc, N - 1)]
        for i in range(1, N_REGS):
            binds.append((f"x{i}_in", self.m_x + i, 0))
            binds.append((f"x{i}_out", self.m_x + i, N - 1))
        for name, pol, idx in binds:
            pub = p.public_input(name, cm(pol), idx)
            gate = l1 if idx == 0 else llast
            p.identity(p.mul(gate, p.sub(cm(pol), pub)), "rv32.pil", 71)

        self.pil = p.build()
        self.const_pols = self._fill_constants()

    # ------------------------------------------------------------------
    def _fill_constants(self) -> PolsArray:
        cp = PolsArray(self.pil, PolsArray.CONSTANT)
        buf = cp.buffer
        N = self.N
        buf[0, self.c_l1] = 1
        buf[N - 1, self.c_llast] = 1
        buf[:, self.c_byte] = np.arange(N, dtype=np.uint64) % 256
        buf[:, self.c_line] = np.arange(N, dtype=np.uint64)
        op_index = {op: i for i, op in enumerate(ALL_OPS)}
        for j, (pc, ins) in enumerate(sorted(self.program.items())):
            buf[j, self.c_rom_on] = 1
            buf[j, self.c_rom_pc] = pc
            buf[j, self.c_rom_sel + op_index[ins.op]] = 1
            buf[j, self.c_rom_imm] = self._rom_imm(ins)
            if ins.op in WRITES_RD and ins.rd != 0:
                buf[j, self.c_rom_rd + ins.rd] = 1
            buf[j, self.c_rom_rs1 + ins.rs1] = 1
            buf[j, self.c_rom_rs2 + ins.rs2] = 1
        row = 0
        for tag, fn in ((0, lambda a, b: a & b), (1, lambda a, b: a | b),
                        (2, lambda a, b: a ^ b)):
            for a in range(16):
                for b in range(16):
                    buf[row, self.c_nib_on] = 1
                    buf[row, self.c_nib_tag] = tag
                    buf[row, self.c_nib_a] = a
                    buf[row, self.c_nib_b] = b
                    buf[row, self.c_nib_out] = fn(a, b)
                    row += 1
        if self.continuations:
            self._fill_cont_constants(buf)
        return cp

    def _fill_cont_constants(self, buf):
        """Identical schedule to machine.py's continuation constants."""
        from .continuations import _PABS, _PBLK, _PROUNDS, _poseidon_tables

        CP, _ = _poseidon_tables()
        N = self.N
        nblk = self.ram_words // _PABS
        for img in (0, 1):
            on_col = self.c_img1_on if img == 0 else self.c_img2_on
            for k in range(nblk):
                base = (img * nblk + k) * _PBLK
                for l in range(_PABS):
                    buf[base + l, self.c_img_addr] = _PABS * k + l
                    buf[base + l, on_col] = 1
                init = base + _PABS
                buf[init, self.c_pinit] = 1
                buf[init, self.c_pcap0 if k == 0 else self.c_pinit_chain] = 1
                for j in range(_PROUNDS):
                    r = init + j
                    for i in range(12):
                        buf[r, self.c_pos_rc + i] = CP[j][i]
                    full = j < 4 or j >= 26
                    buf[r, self.c_pos_full_on if full
                        else self.c_pos_part_on] = 1
                end = init + _PROUNDS
                buf[end, self.c_nl_pend] = 1
                if img == 0 and k == nblk - 1:
                    buf[end, self.c_nl_dig] = 1
        nl = np.ones(N, dtype=np.uint64)
        nl[N - 1] = 0
        buf[:, self.c_nl_npend] = nl - buf[:, self.c_nl_pend]
        buf[:, self.c_nl_ndig] = nl - buf[:, self.c_nl_dig]

    def _rom_imm(self, ins: RvInstr) -> int:
        """Branch/jal offsets as signed-mod-p; everything else mod 2^32."""
        if ins.op in BRANCHES.values() or ins.op == "jal":
            return _sgn_to_field(ins.imm)
        return ins.imm & MASK32

    # ------------------------------------------------------------------
    def trace(self, states, image_in=None) -> PolsArray:
        """Commit columns from rv32_isa.execute states (RvState list).
        sb/sh expand to two rows; pads by spinning at the final ecall."""
        N = self.N
        cmp = PolsArray(self.pil, PolsArray.COMMIT)
        buf = cmp.buffer
        op_index = {op: i for i, op in enumerate(ALL_OPS)}
        prog = self.program
        if self.continuations:
            assert image_in is not None and len(image_in) == self.ram_words

        # expand to rows: (state, phase, next_state, skip)
        rows = []
        for i, st in enumerate(states):
            ins = prog[st.pc]
            nxt = states[i + 1] if i + 1 < len(states) else None
            if ins.op in TWO_CYCLE and nxt is not None:
                rows.append((st, 0, nxt, False))
                rows.append((st, 1, nxt, False))
            else:
                rows.append((st, 0, nxt, False))
        if len(rows) > N:
            raise ValueError("execution (with micro-rows) exceeds the chunk")
        halted = states[-1].halted
        if not halted:
            # freeze the boundary row: its instruction executes in the
            # NEXT chunk, so the skip run must start right at it.  This
            # holds for EXACT-FIT chunks too (executed rows + boundary
            # == N): leaving the boundary row active feeds a memory-op
            # with no successor state into the sorted-mem argument and
            # the Z grand product no longer closes (hit by any guest
            # whose rows are all single-cycle, e.g. guest_secp256k1).
            st, phase, nxt, _ = rows[-1]
            rows[-1] = (st, phase, nxt, True)
        while len(rows) < N:
            # final chunks spin at the ecall; non-final chunks pad with
            # frozen `skip` rows at the boundary state
            rows.append((states[-1], 0, None, not halted))
        mem_ops = []

        for r, (st, phase, nxt, skipped) in enumerate(rows):
            ins = prog[st.pc]
            op = ins.op
            regs = st.regs
            buf[r, self.m_pc] = st.pc
            buf[r, self.m_ph] = phase
            buf[r, self.m_skip] = 1 if skipped else 0
            for i in range(N_REGS):
                buf[r, self.m_x + i] = regs[i]
            buf[r, self.m_sel + op_index[op]] = 1
            imm_f = self._rom_imm(ins)
            buf[r, self.m_imm] = imm_f
            if op in WRITES_RD and ins.rd != 0:
                buf[r, self.m_rd1h + ins.rd] = 1
            buf[r, self.m_rs11h + ins.rs1] = 1
            buf[r, self.m_rs21h + ins.rs2] = 1
            a = regs[ins.rs1]
            b = regs[ins.rs2]
            buf[r, self.m_rs1v] = a
            buf[r, self.m_rs2v] = b
            # arg2 column = rs2v on R-form/branch rows, else the ROM imm
            # (which is a signed-mod-p offset on jal rows — the 32-bit
            # gadgets are gated off there)
            arg2_f = b if (op in R_FORM or op in BRANCHES.values()) else imm_f
            buf[r, self.m_arg2] = arg2_f
            self._fill_row_helpers(buf, r, ins, a, b, arg2_f & MASK32,
                                   arg2_f, st, phase, nxt, mem_ops)

        continuations.fill_sorted_mem(self, buf, mem_ops)
        if self.continuations:
            continuations.fill_trace(self, buf, mem_ops, image_in)
        return cmp

    def _fill_row_helpers(self, buf, r, ins, a, b, arg2, arg2_f, st, phase,
                          nxt, mem_ops):
        op = ins.op
        W = WORD

        def put_bytes(base, v, n=4):
            for k in range(n):
                buf[r, base + k] = (v >> (8 * k)) & 0xFF

        rdv = 0
        if nxt is not None and ins.rd != 0 and op in WRITES_RD:
            rdv = nxt.regs[ins.rd]
        elif nxt is None and op in WRITES_RD:
            # frozen skip row at a chunk boundary: the instruction has NOT
            # executed (identity 10 gates the register write by nskip, the
            # memory argument is gated off), but the per-op ALU identities
            # are selector-gated only — fill rdv with the value the op
            # WOULD produce so they hold.  Loads see the synthetic old=0
            # word, so their extracted value is 0.
            rdv = 0 if op in MEM_OPS else _alu_result(op, ins, a, b,
                                                      arg2, st.pc)
        if op in ("jal", "jalr"):
            # the link-value identity is unconditional even when rd = x0
            rdv = (st.pc + 4) & MASK32
        buf[r, self.m_rdv] = rdv
        put_bytes(self.m_bytes_rd, rdv)
        put_bytes(self.m_bytes_rs1, a)
        put_bytes(self.m_bytes_rs2, b)
        put_bytes(self.m_bytes_arg2, arg2)
        a31, b31, i31 = a >> 31, b >> 31, arg2 >> 31
        buf[r, self.m_a31] = a31
        buf[r, self.m_a7l] = (a >> 24) & 0x7F
        buf[r, self.m_b31] = b31
        buf[r, self.m_b7l] = (b >> 24) & 0x7F
        buf[r, self.m_i31] = i31
        buf[r, self.m_i7l] = (arg2 >> 24) & 0x7F

        # add/sub carries
        if op in ("add", "addi"):
            buf[r, self.m_carry] = (a + arg2) // W
        elif op == "sub":
            buf[r, self.m_carry] = 1 if a < arg2 else 0
        elif op == "auipc":
            buf[r, self.m_carry] = (st.pc + (ins.imm & MASK32)) // W

        # multiply core
        if op in ("mul", "mulh", "mulhu", "mulhsu"):
            prod = a * b
            mlo, mhi = prod & MASK32, prod >> 32
            buf[r, self.m_mlo] = mlo
            buf[r, self.m_mhi] = mhi
            put_bytes(self.m_bytes_mlo, mlo)
            put_bytes(self.m_bytes_mhi, mhi)
            if op == "mulh":
                t = mhi - a31 * b - b31 * a + a31 * b31 * W + 2 * W
                k = (t - rdv) // W
                buf[r, self.m_k0] = k & 1
                buf[r, self.m_k1] = (k >> 1) & 1
            elif op == "mulhsu":
                t = mhi - a31 * b + W
                buf[r, self.m_k0] = (t - rdv) // W

        # equality / compares (iz/dinv are unconditional: use the FIELD
        # value of arg2, which differs from the masked one on jal rows)
        diff = (a - arg2_f) % P_INT
        buf[r, self.m_iz] = 1 if diff == 0 else 0
        buf[r, self.m_dinv] = pow(diff, P_INT - 2, P_INT) if diff else 0
        buf[r, self.m_izb] = 1 if b == 0 else 0
        buf[r, self.m_dinvb] = pow(b, P_INT - 2, P_INT) if b else 0

        def fill_ltu(a_, b_, lt_col, bytes_base):
            lt = 1 if a_ < b_ else 0
            buf[r, lt_col] = lt
            low = (a_ - b_ + W - (1 - lt) * W) % P_INT
            put_bytes(bytes_base, low)

        fill_ltu(a, arg2, self.m_lt, self.m_bytes_lt)
        af = (a + (1 << 31) * (1 - 2 * a31)) % P_INT
        bf = (arg2 + (1 << 31) * (1 - 2 * i31)) % P_INT
        fill_ltu(af, bf, self.m_lts, self.m_bytes_lts)

        # bitwise nibbles
        if op in BITWISE:
            res = {"and": a & arg2, "or": a | arg2, "xor": a ^ arg2,
                   "andi": a & arg2, "ori": a | arg2,
                   "xori": a ^ arg2}[op]
            for k in range(8):
                buf[r, self.m_na + k] = (a >> (4 * k)) & 0xF
                buf[r, self.m_nb + k] = (arg2 >> (4 * k)) & 0xF
                buf[r, self.m_no + k] = (res >> (4 * k)) & 0xF

        # shifts
        if op in SHIFTS:
            sh = (b if op in ("sll", "srl", "sra") else ins.imm) & 31
            for k in range(5):
                buf[r, self.m_shb + k] = (sh >> k) & 1
            if op in ("sll", "srl", "sra"):
                qsh = b >> 5
                buf[r, self.m_qsh] = qsh
                put_bytes(self.m_bytes_qsh, qsh)
            p2 = 1 << sh
            buf[r, self.m_p2c] = W >> sh
            if op in RIGHT_SHIFTS:
                q, rem = a >> sh, a & (p2 - 1)
                buf[r, self.m_shq] = q
                put_bytes(self.m_bytes_shq, q)
                buf[r, self.m_shr] = rem
                put_bytes(self.m_bytes_shr, rem)
                buf[r, self.m_shc] = p2 - 1 - rem
                put_bytes(self.m_bytes_shc, p2 - 1 - rem)
            else:
                ov = (a * p2) >> 32
                buf[r, self.m_shr] = ov
                put_bytes(self.m_bytes_shr, ov)
                buf[r, self.m_shc] = p2 - 1 - ov
                put_bytes(self.m_bytes_shc, p2 - 1 - ov)
        else:
            # shift window pin is gated by is_shift, but p2c is multiplied
            # against p2=1 on non-shift rows only inside gated identities
            buf[r, self.m_p2c] = 0

        # divider
        if op in DIV_CLASS:
            signed = op in ("div", "rem")
            sa = a - W if (signed and a31) else a
            sb = b - W if (signed and b31) else b
            ma, mb = abs(sa), abs(sb)
            if mb == 0:
                qm, rm = 0, ma
            else:
                qm, rm = ma // mb, ma % mb
            buf[r, self.m_qm] = qm
            put_bytes(self.m_bytes_qm, qm)
            buf[r, self.m_rm] = rm
            put_bytes(self.m_bytes_rm, rm)
            fill_ltu(rm, mb, self.m_ltd, self.m_bytes_ltd)
            buf[r, self.m_izq] = 1 if qm == 0 else 0
            buf[r, self.m_dinvq] = pow(qm, P_INT - 2, P_INT) if qm else 0
            buf[r, self.m_izr] = 1 if rm == 0 else 0
            buf[r, self.m_dinvr] = pow(rm, P_INT - 2, P_INT) if rm else 0
        else:
            # the unconditional ltd gadget still needs consistent values
            # for (rm=0, mb=operand-dependent): with is_sdiv=0, im_mb = rs2v
            fill_ltu(0, b, self.m_ltd, self.m_bytes_ltd)
            buf[r, self.m_dinvr] = 0
            buf[r, self.m_izr] = 1
            buf[r, self.m_izq] = 1

        # jalr target split
        if op == "jalr":
            t1 = a + (ins.imm & MASK32)
            jw = t1 // W
            t1 &= MASK32
            j0 = t1 & 1
            buf[r, self.m_jw] = jw
            buf[r, self.m_j0] = j0
            buf[r, self.m_jhalf] = (t1 - j0) >> 1
            put_bytes(self.m_bytes_jh, (t1 - j0) >> 1)

        # memory.  On boundary/skip rows (nxt is None) the instruction has
        # not executed: the memory argument is gated off, but the gated
        # per-op identities still hold with mwold = 0 and the matching
        # derived values.
        if op in MEM_OPS and (nxt is None or nxt.mem_op is not None):
            if nxt is not None:
                wa, old, new, iswr = nxt.mem_op
            else:
                addr0 = (a + (ins.imm & MASK32)) % W
                wa, old = addr0 >> 2, 0
                off0 = addr0 & 3
                if op == "sw":
                    new = b
                elif op == "sb":
                    new = (b & 0xFF) << (8 * off0)
                elif op == "sh":
                    new = (b & 0xFFFF) << (8 * off0)
                else:
                    new = 0
            # the committed column (and the memory/continuation argument)
            # carries image-relative word addresses
            wa -= self.mem_base
            assert 0 <= wa < (self.ram_words or (1 << 30)), \
                f"access at word {wa + self.mem_base:#x} outside the RAM " \
                f"image [{self.mem_base:#x}, " \
                f"{self.mem_base + (self.ram_words or 0):#x})"
            addrb = (a + (ins.imm & MASK32)) % W
            buf[r, self.m_ac] = (a + (ins.imm & MASK32)) // W
            buf[r, self.m_addrb] = addrb
            put_bytes(self.m_bytes_addr, addrb)
            buf[r, self.m_addr] = wa
            put_bytes(self.m_bytes_wa, wa)
            buf[r, self.m_o0] = addrb & 1
            buf[r, self.m_o1] = (addrb >> 1) & 1
            buf[r, self.m_mwold] = old
            put_bytes(self.m_bytes_mw, old)
            buf[r, self.m_mwnew] = new
            off = addrb & 3
            byte = (old >> (8 * off)) & 0xFF
            buf[r, self.m_lbl] = byte & 0x7F
            buf[r, self.m_lb7] = byte >> 7
            hoff = (off >> 1) & 1
            half = (old >> (16 * hoff)) & 0xFFFF
            buf[r, self.m_lhl] = (half >> 8) & 0x7F
            buf[r, self.m_lh15] = half >> 15
            if nxt is None:
                pass  # boundary/skip row: op executes in the next chunk
            elif op == "sw":
                mem_ops.append((wa, r, new, 1))
            elif op in TWO_CYCLE:
                if phase == 0:
                    mem_ops.append((wa, r, old, 0))
                else:
                    mem_ops.append((wa, r, new, 1))
            else:  # loads read the whole word
                mem_ops.append((wa, r, old, 0))
