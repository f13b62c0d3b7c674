"""MiniRV: the zkVM's instruction set + assembler.

The reference proves RISC-V guests through the external powdr toolchain
(zkvm/src/lib.rs:172 compile_rust -> powdr-asm -> PIL).  This framework
ships its own native machine: a 16-register RV32E-style word machine whose
arithmetization (zkvm/machine.py) fits the eSTARK prover directly.

Instructions (one word each, absolute word-addressed pc):
  add/sub/mul rd, rs1, rs2      32-bit wrapping ALU
  addi        rd, rs1, imm      imm taken mod 2^32
  beq/bne/blt rs1, rs2, label   unsigned blt
  jal         rd, label         rd <- pc+1 (x0 discards)
  jalr        rd, rs1, imm      pc <- rs1+imm, rd <- pc+1
  in          rd                rd <- next input-tape word
  halt                          spin (pc' = pc)
Pseudo: li rd, imm (addi rd, x0, imm); mv rd, rs (addi rd, rs, 0);
        j label (jal x0, label); nop.

Copy of eigen_zkvm_tpu/zkvm/isa.py for the PyTorch port.
"""
from __future__ import annotations

from dataclasses import dataclass

OPS = ("add", "sub", "mul", "addi", "beq", "bne", "blt", "jal", "jalr",
       "in", "halt", "lw", "sw", "mulh", "and", "or", "xor")
N_REGS = 16
WORD = 1 << 32


@dataclass
class Instr:
    op: str
    rd: int = 0
    rs1: int = 0
    rs2: int = 0
    imm: int = 0


def _reg(tok: str) -> int:
    tok = tok.strip().rstrip(",")
    assert tok.startswith("x"), f"bad register {tok}"
    r = int(tok[1:])
    assert 0 <= r < N_REGS, f"register out of range {tok}"
    return r


def assemble(src: str) -> list[Instr]:
    """Two-pass assembler with labels; returns the program."""
    lines = []
    for raw in src.splitlines():
        line = raw.split("#")[0].split("//")[0].strip()
        if line:
            lines.append(line)
    labels = {}
    pc = 0
    parsed = []
    for line in lines:
        while ":" in line:
            label, line = line.split(":", 1)
            labels[label.strip()] = pc
            line = line.strip()
        if line:
            parsed.append(line)
            pc += 1
    prog = []
    for pc, line in enumerate(parsed):
        toks = line.replace(",", " ").split()
        op, args = toks[0].lower(), toks[1:]

        def imm_or_label(tok):
            return labels[tok] if tok in labels else int(tok, 0)

        if op in ("add", "sub", "mul", "mulh", "and", "or", "xor"):
            prog.append(Instr(op, _reg(args[0]), _reg(args[1]),
                              _reg(args[2])))
        elif op == "addi":
            prog.append(Instr(op, _reg(args[0]), _reg(args[1]),
                              imm=imm_or_label(args[2]) % WORD))
        elif op == "li":
            prog.append(Instr("addi", _reg(args[0]), 0,
                              imm=imm_or_label(args[1]) % WORD))
        elif op == "mv":
            prog.append(Instr("addi", _reg(args[0]), _reg(args[1]), imm=0))
        elif op in ("beq", "bne", "blt"):
            prog.append(Instr(op, 0, _reg(args[0]), _reg(args[1]),
                              imm=imm_or_label(args[2])))
        elif op == "jal":
            prog.append(Instr(op, _reg(args[0]), imm=imm_or_label(args[1])))
        elif op == "j":
            prog.append(Instr("jal", 0, imm=imm_or_label(args[0])))
        elif op == "jalr":
            prog.append(Instr(op, _reg(args[0]), _reg(args[1]),
                              imm=imm_or_label(args[2]) % WORD))
        elif op == "in":
            prog.append(Instr("in", _reg(args[0])))
        elif op == "lw":  # lw rd, rs1, imm : rd <- M[rs1 + imm]
            prog.append(Instr("lw", _reg(args[0]), _reg(args[1]),
                              imm=imm_or_label(args[2]) % WORD))
        elif op == "sw":  # sw rs2, rs1, imm : M[rs1 + imm] <- rs2
            prog.append(Instr("sw", 0, _reg(args[1]), _reg(args[0]),
                              imm=imm_or_label(args[2]) % WORD))
        elif op == "halt":
            prog.append(Instr("halt"))
        elif op == "nop":
            prog.append(Instr("addi", 0, 0, imm=0))
        else:
            raise ValueError(f"unknown instruction {op!r}")
    if not prog or prog[-1].op != "halt":
        prog.append(Instr("halt"))
    return prog


@dataclass
class State:
    pc: int
    regs: list
    in_idx: int
    halted: bool = False
    # (addr, value, is_write) of the memory op executed by the PREVIOUS
    # cycle (the one that produced this state), or None
    mem_op: tuple | None = None


def execute(prog: list[Instr], inputs: list[int], max_cycles: int = 1 << 20,
            state: State | None = None, mem: dict | None = None):
    """Run the program; returns (states, final_state) where states[i] is the
    machine state BEFORE cycle i (states has len cycles+1).  `mem` is the
    word-addressed RAM (lw/sw); it is mutated in place."""
    if mem is None:
        mem = {}
    st = state or State(0, [0] * N_REGS, 0)
    states = [State(st.pc, list(st.regs), st.in_idx, st.halted)]
    for _ in range(max_cycles):
        ins = prog[st.pc]
        regs = st.regs
        if ins.op == "halt":
            st.halted = True
            states[-1].halted = True
            break
        rd, a, b2 = ins.rd, regs[ins.rs1], regs[ins.rs2]
        npc = st.pc + 1
        val = None
        if ins.op == "add":
            val = (a + b2) % WORD
        elif ins.op == "sub":
            val = (a - b2) % WORD
        elif ins.op == "mul":
            val = (a * b2) % WORD
        elif ins.op == "mulh":
            val = (a * b2) // WORD
        elif ins.op == "and":
            val = a & b2
        elif ins.op == "or":
            val = a | b2
        elif ins.op == "xor":
            val = a ^ b2
        elif ins.op == "addi":
            val = (a + ins.imm) % WORD
        elif ins.op == "beq":
            npc = ins.imm if a == b2 else npc
        elif ins.op == "bne":
            npc = ins.imm if a != b2 else npc
        elif ins.op == "blt":
            npc = ins.imm if a < b2 else npc
        elif ins.op == "jal":
            val = st.pc + 1
            npc = ins.imm
        elif ins.op == "jalr":
            val = st.pc + 1
            npc = (regs[ins.rs1] + ins.imm) % WORD
        elif ins.op == "in":
            val = inputs[st.in_idx] % WORD
            st.in_idx += 1
        mem_op = None
        if ins.op == "lw":
            addr = (a + ins.imm) % WORD
            val = mem.get(addr, 0)
            mem_op = (addr, val, 0)
        elif ins.op == "sw":
            addr = (a + ins.imm) % WORD
            mem[addr] = b2
            mem_op = (addr, b2, 1)
        if val is not None and rd != 0:
            regs[rd] = val
        st.pc = npc
        states.append(State(st.pc, list(regs), st.in_idx, st.halted,
                            mem_op=mem_op))
    return states, st
