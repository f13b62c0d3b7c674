"""MiniRV arithmetization: machine PIL + trace generation.

The zkVM's constraint system, built on the PIL authoring API
(stark/pil_builder.py) and proven by the standard eSTARK pipeline — the
native replacement for the reference's powdr-generated machine PIL
(zkvm/src/lib.rs compile_rust/Pipeline).

Design (one row per cycle):
  - full register file as 16 committed columns; writes via ROM-provided
    one-hot selectors
  - instruction fetch as a wide plookup of the decoded fields against a
    constant ROM table keyed by pc
  - 32-bit semantics via byte-decomposition plookups into a cyclic BYTE
    table (add/sub carries, mul high word, unsigned-compare borrow)
  - read-only input tape as a (counter, value) plookup — the reference's
    prover-input channel (powdr bootloader data) analog
  - chunk-boundary state (pc, registers, tape position) exposed as publics
    at the first/last row for continuations

Copy of eigen_zkvm_tpu/zkvm/machine.py for the PyTorch port, imports
pointed at the port.
"""
from __future__ import annotations

import numpy as np

from ..ops import gl
from ..stark.pil_builder import PilBuilder
from ..stark.polsarray import PolsArray
from . import continuations
from .continuations import _PABS, _PBLK, _PROUNDS, ram_digest  # noqa: F401
from .isa import Instr, N_REGS, OPS, WORD

SEL_OPS = OPS  # one selector column per op

class MiniRVMachine:
    NS = "Zkvm"  # PIL namespace (shared continuation columns use it)

    """PIL + constant pols for a fixed (program, tape-capacity) pair.

    `ram_words` enables MEMORY CONTINUATIONS (the powdr-bootloader analog,
    reference zkvm/src/lib.rs:215-223,319-365): RAM is a fixed M-word image
    whose incoming and outgoing snapshots are hashed INSIDE the trace by a
    Poseidon-GL coprocessor section (31-row permutation pipelines over the
    POSEIDON12 gate's non-opt round function), and the two digests are
    exposed as publics chained across chunks like the register state.  The
    memory argument reads fresh addresses out of the incoming image and a
    touched-address permutation pins the outgoing image, so a multi-chunk
    RAM execution is sound end-to-end."""

    def __init__(self, program: list[Instr], n_bits: int = 12,
                 tape_size: int | None = None,
                 ram_words: int | None = None):
        self.program = program
        self.n_bits = n_bits
        assert n_bits <= 16, "step-difference range checks use 2 bytes"
        self.N = 1 << n_bits
        assert len(program) <= self.N
        self.tape_size = tape_size if tape_size is not None else self.N // 4
        self.has_mem = any(i.op in ("lw", "sw") for i in program)
        self.has_mulh = any(i.op == "mulh" for i in program)
        self.has_bitwise = any(i.op in ("and", "or", "xor") for i in program)
        if self.has_bitwise:
            assert self.N >= 1024, "bitwise ops need the 768-row nibble table"
        self.ram_words = ram_words
        self.continuations = ram_words is not None
        if self.continuations:
            assert self.has_mem, "ram_words without lw/sw is pointless"
            assert ram_words % 8 == 0, "image size must fill rate-8 blocks"
            # two image pipelines of (M/8) blocks x 39 rows (8 absorb rows
            # + init + 30 round transitions), ending before the wrap row
            assert continuations.rows_needed(ram_words) + 1 < self.N, \
                "ram_words too large for this chunk size"
        self._build_pil()

    def _build_pil(self):
        p = PilBuilder(self.n_bits)
        self.p = p
        N = self.N

        # constants
        self.c_l1 = p.const_pol("Global.L1")
        self.c_llast = p.const_pol("Zkvm.LLAST")
        self.c_byte = p.const_pol("Zkvm.BYTE")
        self.c_rom_on = p.const_pol("Zkvm.ROM_ON")
        self.c_rom_pc = p.const_pol("Zkvm.ROM_PC")
        self.c_rom_sel = p.const_pol("Zkvm.ROM_SEL", len(SEL_OPS))
        self.c_rom_imm = p.const_pol("Zkvm.ROM_IMM")
        self.c_rom_rd = p.const_pol("Zkvm.ROM_RD", N_REGS)
        self.c_rom_rs1 = p.const_pol("Zkvm.ROM_RS1", N_REGS)
        self.c_rom_rs2 = p.const_pol("Zkvm.ROM_RS2", N_REGS)
        self.c_tape_on = p.const_pol("Zkvm.TAPE_ON")
        self.c_tape_idx = p.const_pol("Zkvm.TAPE_IDX")
        self.c_tape_val = p.const_pol("Zkvm.TAPE_VAL")
        if self.has_mem:
            self.c_line = p.const_pol("Zkvm.LINE")
        if self.continuations:
            continuations.declare_consts(self, p)
        if self.has_bitwise:
            # nibble-pair op table: 768 rows of (tag, a, b, out) with
            # tag 0=and 1=or 2=xor (requires N >= 1024)
            self.c_nib_on = p.const_pol("Zkvm.NIB_ON")
            self.c_nib_tag = p.const_pol("Zkvm.NIB_TAG")
            self.c_nib_a = p.const_pol("Zkvm.NIB_A")
            self.c_nib_b = p.const_pol("Zkvm.NIB_B")
            self.c_nib_out = p.const_pol("Zkvm.NIB_OUT")

        # commits
        self.m_pc = p.cm_pol("Zkvm.pc")
        self.m_x = p.cm_pol("Zkvm.x", N_REGS)
        self.m_sel = p.cm_pol("Zkvm.sel", len(SEL_OPS))
        self.m_imm = p.cm_pol("Zkvm.imm")
        self.m_rd1h = p.cm_pol("Zkvm.rd1h", N_REGS)
        self.m_rs11h = p.cm_pol("Zkvm.rs11h", N_REGS)
        self.m_rs21h = p.cm_pol("Zkvm.rs21h", N_REGS)
        self.m_rs1v = p.cm_pol("Zkvm.rs1v")
        self.m_rs2v = p.cm_pol("Zkvm.rs2v")
        self.m_rdv = p.cm_pol("Zkvm.rdv")
        self.m_carry = p.cm_pol("Zkvm.carry")
        self.m_hi = p.cm_pol("Zkvm.hi")
        self.m_iz = p.cm_pol("Zkvm.iz")
        self.m_dinv = p.cm_pol("Zkvm.dinv")
        self.m_lt = p.cm_pol("Zkvm.lt")
        self.m_inidx = p.cm_pol("Zkvm.in_idx")
        self.m_bytes_rd = p.cm_pol("Zkvm.bytes_rd", 4)
        self.m_bytes_hi = p.cm_pol("Zkvm.bytes_hi", 4)
        self.m_bytes_lt = p.cm_pol("Zkvm.bytes_lt", 4)
        if self.has_mulh:
            self.m_mlo = p.cm_pol("Zkvm.mlo")
            self.m_bytes_mlo = p.cm_pol("Zkvm.bytes_mlo", 4)
        if self.has_bitwise:
            self.m_na = p.cm_pol("Zkvm.na", 8)
            self.m_nb = p.cm_pol("Zkvm.nb", 8)
            self.m_no = p.cm_pol("Zkvm.no", 8)
        if self.has_mem:
            # execution side of the RAM argument
            self.m_addr = p.cm_pol("Zkvm.addr")
            self.m_ac = p.cm_pol("Zkvm.ac")
            self.m_bytes_addr = p.cm_pol("Zkvm.bytes_addr", 4)
            # address/step-sorted side
            self.s_on = p.cm_pol("Zkvm.s_on")
            self.s_addr = p.cm_pol("Zkvm.s_addr")
            self.s_step = p.cm_pol("Zkvm.s_step")
            self.s_val = p.cm_pol("Zkvm.s_val")
            self.s_iswr = p.cm_pol("Zkvm.s_iswr")
            self.s_same = p.cm_pol("Zkvm.s_same")
            self.s_dinv = p.cm_pol("Zkvm.s_dinv")
            self.s_bytes_sd = p.cm_pol("Zkvm.s_bytes_sd", 2)
            self.s_bytes_ad = p.cm_pol("Zkvm.s_bytes_ad", 4)
        if self.continuations:
            continuations.declare_commits(self, p)

        sel = {op: p.cm(self.m_sel + i) for i, op in enumerate(SEL_OPS)}
        cm, const, num = p.cm, p.const, p.num
        x = [cm(self.m_x + i) for i in range(N_REGS)]
        xp = [cm(self.m_x + i, True) for i in range(N_REGS)]
        pc, pcp = cm(self.m_pc), cm(self.m_pc, True)
        rs1v, rs2v, rdv = cm(self.m_rs1v), cm(self.m_rs2v), cm(self.m_rdv)
        imm = cm(self.m_imm)
        llast = const(self.c_llast)
        not_last = p.sub(num(1), llast)
        W32 = 1 << 32

        # fetch plookup: decoded fields must match the ROM row at pc
        f = [pc] + [sel[o] for o in SEL_OPS] + [imm]
        t = [const(self.c_rom_pc)] + \
            [const(self.c_rom_sel + i) for i in range(len(SEL_OPS))] + \
            [const(self.c_rom_imm)]
        for base_c, base_m in ((self.c_rom_rd, self.m_rd1h),
                               (self.c_rom_rs1, self.m_rs11h),
                               (self.c_rom_rs2, self.m_rs21h)):
            f += [cm(base_m + i) for i in range(N_REGS)]
            t += [const(base_c + i) for i in range(N_REGS)]
        p.plookup(f=f, t=t, sel_f=None, sel_t=const(self.c_rom_on),
                  file_name="zkvm.pil", line=1)

        # operand binding: rs1v = sum rs1_onehot_i * x_i
        p.identity(p.sub(rs1v, p.lin(
            [(1, p.mul(cm(self.m_rs11h + i), x[i])) for i in range(N_REGS)])),
            "zkvm.pil", 2)
        p.identity(p.sub(rs2v, p.lin(
            [(1, p.mul(cm(self.m_rs21h + i), x[i])) for i in range(N_REGS)])),
            "zkvm.pil", 3)
        p.identity(x[0], "zkvm.pil", 4)  # x0 == 0

        # register updates (gated off on the wrap-around row)
        for i in range(N_REGS):
            wr = p.intermediate(p.mul(cm(self.m_rd1h + i), p.sub(rdv, x[i])))
            p.identity(p.mul(not_last, p.sub(p.sub(xp[i], x[i]), wr)),
                       "zkvm.pil", 5)

        # ALU
        carry = cm(self.m_carry)
        hi = cm(self.m_hi)
        p.identity(p.mul(carry, p.sub(num(1), carry)), "zkvm.pil", 6)
        p.identity(p.mul(sel["add"], p.sub(p.add(rs1v, rs2v),
                                           p.add(rdv, p.smul(W32, carry)))),
                   "zkvm.pil", 7)
        p.identity(p.mul(sel["sub"], p.sub(p.add(rs1v, p.smul(W32, carry)),
                                           p.add(rs2v, rdv))),
                   "zkvm.pil", 8)
        p.identity(p.mul(sel["addi"], p.sub(p.add(rs1v, imm),
                                            p.add(rdv, p.smul(W32, carry)))),
                   "zkvm.pil", 9)
        prod = p.intermediate(p.mul(rs1v, rs2v))
        p.identity(p.mul(sel["mul"], p.sub(prod, p.add(rdv, p.smul(W32, hi)))),
                   "zkvm.pil", 10)
        if self.has_mulh:
            # mulh: prod = mlo + 2^32 * rdv, with mlo byte-ranged
            mlo = cm(self.m_mlo)
            p.identity(p.mul(sel["mulh"],
                             p.sub(prod, p.add(mlo, p.smul(W32, rdv)))),
                       "zkvm.pil", 25)
            mlo_bytes = p.lin([(1 << (8 * k), cm(self.m_bytes_mlo + k))
                               for k in range(4)])
            p.identity(p.sub(mlo, mlo_bytes), "zkvm.pil", 26)
            for k in range(4):
                p.plookup(f=[cm(self.m_bytes_mlo + k)],
                          t=[const(self.c_byte)], file_name="zkvm.pil",
                          line=27)
        if self.has_bitwise:
            # nibble decomposition bound to the operand/result values on
            # bitwise rows; range + semantics come from the table lookups
            is_bw = p.lin([(1, sel["and"]), (1, sel["or"]),
                           (1, sel["xor"])])
            tag = p.lin([(1, sel["or"]), (2, sel["xor"])])
            for val, base in ((rs1v, self.m_na), (rs2v, self.m_nb),
                              (rdv, self.m_no)):
                nib = p.lin([(1 << (4 * k), cm(base + k)) for k in range(8)])
                p.identity(p.mul(is_bw, p.sub(val, nib)), "zkvm.pil", 28)
            for k in range(8):
                p.plookup(f=[tag, cm(self.m_na + k), cm(self.m_nb + k),
                             cm(self.m_no + k)],
                          t=[const(self.c_nib_tag), const(self.c_nib_a),
                             const(self.c_nib_b), const(self.c_nib_out)],
                          sel_f=is_bw, sel_t=const(self.c_nib_on),
                          file_name="zkvm.pil", line=29)
        p.identity(p.mul(p.add(sel["jal"], sel["jalr"]),
                         p.sub(rdv, p.add(pc, num(1)))), "zkvm.pil", 11)

        # equality / unsigned-less-than helpers
        iz, dinv, lt = cm(self.m_iz), cm(self.m_dinv), cm(self.m_lt)
        diff = p.sub(rs1v, rs2v)
        p.identity(p.mul(iz, diff), "zkvm.pil", 12)
        p.identity(p.sub(p.add(iz, p.mul(diff, dinv)), num(1)), "zkvm.pil", 13)
        p.identity(p.mul(lt, p.sub(num(1), lt)), "zkvm.pil", 14)
        lt_bytes = p.lin([(1 << (8 * k), cm(self.m_bytes_lt + k))
                          for k in range(4)])
        p.identity(p.sub(p.add(p.sub(rs1v, rs2v), num(W32)),
                         p.add(p.mul(p.sub(num(1), lt), num(W32)), lt_bytes)),
                   "zkvm.pil", 15)

        # range decompositions
        rd_bytes = p.lin([(1 << (8 * k), cm(self.m_bytes_rd + k))
                          for k in range(4)])
        p.identity(p.sub(rdv, rd_bytes), "zkvm.pil", 16)
        hi_bytes = p.lin([(1 << (8 * k), cm(self.m_bytes_hi + k))
                          for k in range(4)])
        p.identity(p.sub(hi, hi_bytes), "zkvm.pil", 17)
        for arr in (self.m_bytes_rd, self.m_bytes_hi, self.m_bytes_lt):
            for k in range(4):
                p.plookup(f=[cm(arr + k)], t=[const(self.c_byte)],
                          file_name="zkvm.pil", line=18)

        # pc transition
        taken = p.intermediate(p.lin([
            (1, p.mul(sel["beq"], iz)),
            (1, p.mul(sel["bne"], p.sub(num(1), iz))),
            (1, p.mul(sel["blt"], lt))]))
        delta = p.intermediate(p.lin([
            (1, p.mul(taken, p.sub(imm, p.add(pc, num(1))))),
            (1, p.mul(sel["jal"], p.sub(imm, p.add(pc, num(1))))),
            (1, p.mul(sel["jalr"],
                      p.sub(p.add(rs1v, imm), p.add(pc, num(1))))),
            (gl.P_INT - 1, sel["halt"])]))
        p.identity(p.mul(not_last,
                         p.sub(pcp, p.add(p.add(pc, num(1)), delta))),
                   "zkvm.pil", 19)

        # input tape
        in_idx = cm(self.m_inidx)
        p.identity(p.mul(not_last,
                         p.sub(cm(self.m_inidx, True),
                               p.add(in_idx, sel["in"]))), "zkvm.pil", 20)
        p.plookup(f=[in_idx, rdv],
                  t=[const(self.c_tape_idx), const(self.c_tape_val)],
                  sel_f=sel["in"], sel_t=const(self.c_tape_on),
                  file_name="zkvm.pil", line=21)

        # ---- RAM: address/step-sorted memory argument --------------------
        # Execution rows with lw/sw contribute (addr, LINE, value, is_write)
        # to a selected permutation against a sorted copy; the sorted side
        # proves per-address chronology: step strictly increases within an
        # address segment, reads return the previous value, a fresh address
        # starts with a write or reads zero (zero-initialized RAM), and
        # addresses strictly increase segment to segment.  This is the
        # native analog of powdr's memory machine (reference zkvm guests
        # get RAM from powdr-asm).  Degrees stay <= 2 via intermediates.
        if self.has_mem:
            # a lw/sw on the WRAP row is the boundary snapshot of a chunk
            # that ends mid-program — the op executes as row 0 of the NEXT
            # chunk, so every execution-side memory constraint is gated by
            # is_mem*not_last (committed intermediate to stay degree <= 2)
            is_mem = p.intermediate(p.mul(p.add(sel["lw"], sel["sw"]),
                                          not_last))
            addr, ac = cm(self.m_addr), cm(self.m_ac)
            p.identity(p.mul(ac, p.sub(num(1), ac)), "zkvm.pil", 30)
            p.identity(p.mul(is_mem,
                             p.sub(p.add(rs1v, imm),
                                   p.add(addr, p.smul(W32, ac)))),
                       "zkvm.pil", 31)
            addr_bytes = p.lin([(1 << (8 * k), cm(self.m_bytes_addr + k))
                                for k in range(4)])
            p.identity(p.sub(addr, addr_bytes), "zkvm.pil", 32)
            for k in range(4):
                p.plookup(f=[cm(self.m_bytes_addr + k)],
                          t=[const(self.c_byte)],
                          file_name="zkvm.pil", line=33)
            im_vale = p.intermediate(p.add(p.mul(sel["lw"], rdv),
                                           p.mul(sel["sw"], rs2v)))

            s_on, s_addr = cm(self.s_on), cm(self.s_addr)
            s_step, s_val = cm(self.s_step), cm(self.s_val)
            s_iswr, s_same = cm(self.s_iswr), cm(self.s_same)
            s_onp = cm(self.s_on, True)
            s_addrp = cm(self.s_addr, True)
            s_stepp = cm(self.s_step, True)
            s_valp = cm(self.s_val, True)
            s_iswrp = cm(self.s_iswr, True)

            p.permutation(f=[addr, const(self.c_line), im_vale, sel["sw"]],
                          t=[s_addr, s_step, s_val, s_iswr],
                          sel_f=is_mem, sel_t=s_on,
                          file_name="zkvm.pil", line=34)

            for b in (s_on, s_iswr, s_same):
                p.identity(p.mul(b, p.sub(num(1), b)), "zkvm.pil", 35)
            # participating rows are a prefix: once off, stays off
            # (gated off on the wrap-around row, where s_on' is row 0)
            im_off = p.intermediate(p.mul(s_onp, p.sub(num(1), s_on)))
            p.identity(p.mul(not_last, im_off), "zkvm.pil", 36)

            d = p.sub(s_addrp, s_addr)
            im_seg = p.intermediate(p.mul(s_on, s_onp))
            p.identity(p.mul(s_same, d), "zkvm.pil", 37)
            im_eq = p.intermediate(p.mul(d, cm(self.s_dinv)))
            p.identity(p.mul(im_seg, p.sub(p.add(s_same, im_eq), num(1))),
                       "zkvm.pil", 38)

            im_same = p.intermediate(p.mul(im_seg, s_same))
            self._im_same, self._is_mem = im_same, is_mem
            sd_bytes = p.lin([(1 << (8 * k), cm(self.s_bytes_sd + k))
                              for k in range(2)])
            p.identity(p.mul(im_same,
                             p.sub(p.sub(s_stepp, p.add(s_step, num(1))),
                                   sd_bytes)), "zkvm.pil", 39)
            im_rd = p.intermediate(p.mul(im_same, p.sub(num(1), s_iswrp)))
            p.identity(p.mul(im_rd, p.sub(s_valp, s_val)), "zkvm.pil", 40)

            im_new = p.intermediate(p.mul(im_seg, p.sub(num(1), s_same)))
            im_nw = p.intermediate(p.mul(im_new, p.sub(num(1), s_iswrp)))
            ad_bytes = p.lin([(1 << (8 * k), cm(self.s_bytes_ad + k))
                              for k in range(4)])
            p.identity(p.mul(im_new, p.sub(p.sub(d, num(1)), ad_bytes)),
                       "zkvm.pil", 42)
            im_g0 = p.intermediate(p.mul(const(self.c_l1), s_on))
            im_g0w = p.intermediate(p.mul(im_g0, p.sub(num(1), s_iswr)))
            if not self.continuations:
                # zero-initialized RAM: the first op on a fresh address is a
                # write, or a read returning zero
                p.identity(p.mul(im_nw, s_valp), "zkvm.pil", 41)
                p.identity(p.mul(im_g0w, s_val), "zkvm.pil", 43)
            else:
                # image-initialized RAM: a fresh-address read returns the
                # incoming image word at that address
                img1 = const(self.c_img1_on)
                p.plookup(f=[s_addrp, s_valp],
                          t=[const(self.c_img_addr), cm(self.m_img_w)],
                          sel_f=im_nw, sel_t=img1, file_name="zkvm.pil",
                          line=41)
                p.plookup(f=[s_addr, s_val],
                          t=[const(self.c_img_addr), cm(self.m_img_w)],
                          sel_f=im_g0w, sel_t=img1, file_name="zkvm.pil",
                          line=43)
            for arr, cnt in ((self.s_bytes_sd, 2), (self.s_bytes_ad, 4)):
                for k in range(cnt):
                    p.plookup(f=[cm(arr + k)], t=[const(self.c_byte)],
                              file_name="zkvm.pil", line=44)

        # ---- memory continuations: image table + Poseidon coprocessor ----
        if self.continuations:
            continuations.build(self, p, not_last, llast)

        # continuation publics: state at the first and last row
        l1 = const(self.c_l1)
        binds = [("pc_in", self.m_pc, 0), ("pc_out", self.m_pc, N - 1),
                 ("in_idx_in", self.m_inidx, 0),
                 ("in_idx_out", self.m_inidx, N - 1)]
        for i in range(N_REGS):
            binds.append((f"x{i}_in", self.m_x + i, 0))
            binds.append((f"x{i}_out", self.m_x + i, N - 1))
        for name, pol, idx in binds:
            pub = p.public_input(name, cm(pol), idx)
            gate = l1 if idx == 0 else llast
            p.identity(p.mul(gate, p.sub(cm(pol), pub)), "zkvm.pil", 22)

        self.pil = p.build()
        self.const_pols = self._fill_constants()

    def _fill_constants(self) -> PolsArray:
        cp = PolsArray(self.pil, PolsArray.CONSTANT)
        buf = cp.buffer
        N = self.N
        buf[0, self.c_l1] = 1
        buf[N - 1, self.c_llast] = 1
        buf[:, self.c_byte] = np.arange(N, dtype=np.uint64) % 256
        if self.has_mem:
            buf[:, self.c_line] = np.arange(N, dtype=np.uint64)
        op_index = {op: i for i, op in enumerate(SEL_OPS)}
        for j, ins in enumerate(self.program):
            buf[j, self.c_rom_on] = 1
            buf[j, self.c_rom_pc] = j
            buf[j, self.c_rom_sel + op_index[ins.op]] = 1
            buf[j, self.c_rom_imm] = ins.imm
            writes = ins.op in ("add", "sub", "mul", "addi", "jal", "jalr",
                                "in", "lw", "mulh", "and", "or",
                                "xor") and ins.rd != 0
            if writes:
                buf[j, self.c_rom_rd + ins.rd] = 1
            buf[j, self.c_rom_rs1 + ins.rs1] = 1
            buf[j, self.c_rom_rs2 + ins.rs2] = 1
        buf[: self.tape_size, self.c_tape_on] = 1
        buf[: self.tape_size, self.c_tape_idx] = np.arange(
            self.tape_size, dtype=np.uint64)
        if self.continuations:
            CP, _ = continuations._poseidon_tables()
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
                    buf[init, self.c_pcap0 if k == 0
                        else self.c_pinit_chain] = 1
                    for j in range(_PROUNDS):
                        r = init + j
                        for i in range(12):
                            buf[r, self.c_pos_rc + i] = CP[j][i] \
                                % np.uint64(gl.P_INT)
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
        if self.has_bitwise:
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
        return cp

    def set_tape(self, inputs: list[int]):
        assert len(inputs) <= self.tape_size
        buf = self.const_pols.buffer
        buf[:, self.c_tape_val] = 0
        for i, v in enumerate(inputs):
            buf[i, self.c_tape_val] = v % WORD

    def trace(self, states, inputs=(), image_in=None) -> PolsArray:
        """Fill the commit columns from executed machine states
        (isa.execute output); pads by spinning at the final pc.  A chunk
        that did not halt must supply exactly N states (its boundary row
        carries the outgoing machine state).  With continuations enabled,
        `image_in` is the incoming RAM image ([ram_words] u64)."""
        N = self.N
        assert len(states) <= N, "execution longer than the chunk"
        if not states[-1].halted and len(states) != N:
            raise ValueError("non-final chunk must have exactly N states")
        cmp = PolsArray(self.pil, PolsArray.COMMIT)
        buf = cmp.buffer
        op_index = {op: i for i, op in enumerate(SEL_OPS)}
        prog = self.program
        if self.has_mem and not states[-1].halted and not self.continuations:
            raise NotImplementedError(
                "multi-chunk RAM guests need memory continuations "
                "(pass ram_words= to MiniRVMachine)")
        if self.continuations:
            assert image_in is not None and len(image_in) == self.ram_words, \
                "continuations need the incoming RAM image"

        rows = list(states)
        while len(rows) < N:
            rows.append(rows[-1])  # halt spin
        mem_ops: list = []  # (addr, step, value, is_write)

        for i, st in enumerate(rows):
            ins = prog[st.pc]
            buf[i, self.m_pc] = st.pc
            for r in range(N_REGS):
                buf[i, self.m_x + r] = st.regs[r]
            buf[i, self.m_sel + op_index[ins.op]] = 1
            buf[i, self.m_imm] = ins.imm
            writes = ins.op in ("add", "sub", "mul", "addi", "jal", "jalr",
                                "in", "lw", "mulh", "and", "or",
                                "xor") and ins.rd != 0
            if writes:
                buf[i, self.m_rd1h + ins.rd] = 1
            buf[i, self.m_rs11h + ins.rs1] = 1
            buf[i, self.m_rs21h + ins.rs2] = 1
            a = st.regs[ins.rs1]
            b = st.regs[ins.rs2]
            buf[i, self.m_rs1v] = a
            buf[i, self.m_rs2v] = b
            buf[i, self.m_inidx] = st.in_idx
            rdv = carry = hi = 0
            if ins.op == "add":
                s = a + b
                rdv, carry = s % WORD, s // WORD
            elif ins.op == "sub":
                rdv = (a - b) % WORD
                carry = 1 if a < b else 0
            elif ins.op == "addi":
                s = a + ins.imm
                rdv, carry = s % WORD, s // WORD
            elif ins.op == "mul":
                prod = a * b
                rdv, hi = prod % WORD, prod // WORD
            elif ins.op == "mulh":
                prod = a * b
                rdv = prod // WORD
                mlo = prod % WORD
                buf[i, self.m_mlo] = mlo
                for k in range(4):
                    buf[i, self.m_bytes_mlo + k] = (mlo >> (8 * k)) & 0xFF
            elif ins.op in ("and", "or", "xor"):
                rdv = a & b if ins.op == "and" else \
                    (a | b if ins.op == "or" else a ^ b)
                for k in range(8):
                    buf[i, self.m_na + k] = (a >> (4 * k)) & 0xF
                    buf[i, self.m_nb + k] = (b >> (4 * k)) & 0xF
                    buf[i, self.m_no + k] = (rdv >> (4 * k)) & 0xF
            elif ins.op in ("jal", "jalr"):
                rdv = st.pc + 1
            elif ins.op == "in":
                rdv = inputs[st.in_idx] % WORD
            if ins.op in ("lw", "sw") and i + 1 < len(states):
                addr, mval, iswr = states[i + 1].mem_op
                mem_ops.append((addr, i, mval, iswr))
                s = st.regs[ins.rs1] + ins.imm
                a_c = s // WORD
                buf[i, self.m_addr] = s % WORD
                buf[i, self.m_ac] = a_c
                for k in range(4):
                    buf[i, self.m_bytes_addr + k] = ((s % WORD) >> (8 * k)) \
                        & 0xFF
                if ins.op == "lw":
                    rdv = mval
            buf[i, self.m_rdv] = rdv
            buf[i, self.m_carry] = carry
            buf[i, self.m_hi] = hi
            for k in range(4):
                buf[i, self.m_bytes_rd + k] = (rdv >> (8 * k)) & 0xFF
                buf[i, self.m_bytes_hi + k] = (hi >> (8 * k)) & 0xFF
            diff = (a - b) % gl.P_INT
            buf[i, self.m_iz] = 1 if diff == 0 else 0
            buf[i, self.m_dinv] = pow(diff, gl.P_INT - 2, gl.P_INT) \
                if diff else 0
            lt = 1 if a < b else 0
            buf[i, self.m_lt] = lt
            low = a - b + (1 << 32) - (1 - lt) * (1 << 32)
            for k in range(4):
                buf[i, self.m_bytes_lt + k] = (low >> (8 * k)) & 0xFF

        if self.has_mem:
            continuations.fill_sorted_mem(self, buf, mem_ops)
        if self.continuations:
            continuations.fill_trace(self, buf, mem_ops, image_in)
        return cmp

