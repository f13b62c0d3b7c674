// Native RV32IM executor for the zkVM front-end.
//
// Copy of eigen_zkvm_tpu/native/rv32_exec.cpp for the PyTorch port, which
// builds it with g++ at first use (zkvm/rv32_native.py).  The reference
// executes guests through compiled Rust (powdr's executor,
// zkvm/src/lib.rs:168-231); the Python interpreter in
// zkvm/rv32_isa.py is the semantic authority here but tops out at ~80K
// instr/s and materializes a full register snapshot per cycle.  This
// executor runs the same semantics at ~10^8 instr/s over a dense word
// memory, with optional compact per-cycle trace capture (pc / rd / rdv /
// mem-op) from which chunk states are reconstructed for arithmetization.
//
// Semantics contract (must match rv32_isa.execute EXACTLY — enforced by
// the differential test in tests/test_torch_rv32.py):
//   - x0 never written; jal/jalr link value pc+4; jalr target &~1
//   - div/rem RV32IM spec edge cases (by-zero, MIN_INT/-1)
//   - byte/half loads and stores are word read-modify-write micro-ops;
//     misaligned lw/sw/lh/sh -> error (the Python side asserts)
//   - ecall (and ebreak, decoded as ecall) halts at its own pc
//   - loads record mem_op (wa, w, w, 0), stores (wa, old, new, 1)
//   - row accounting: sb/sh cost 2 trace rows, everything else 1
#include <cstdint>
#include <cstring>

enum Op : uint8_t {
  OP_ADD = 0, OP_SUB, OP_SLL, OP_SLT, OP_SLTU, OP_XOR, OP_SRL, OP_SRA,
  OP_OR, OP_AND, OP_MUL, OP_MULH, OP_MULHSU, OP_MULHU, OP_DIV, OP_DIVU,
  OP_REM, OP_REMU, OP_ADDI, OP_ANDI, OP_ORI, OP_XORI, OP_SLTI, OP_SLTIU,
  OP_SLLI, OP_SRLI, OP_SRAI, OP_LB, OP_LH, OP_LW, OP_LBU, OP_LHU, OP_SB,
  OP_SH, OP_SW, OP_BEQ, OP_BNE, OP_BLT, OP_BGE, OP_BLTU, OP_BGEU, OP_LUI,
  OP_AUIPC, OP_JAL, OP_JALR, OP_ECALL, OP_FENCE
};

// return codes
enum {
  RV_HALTED = 0,        // hit ecall
  RV_ROWS = 1,          // row budget exhausted (paused at a boundary)
  RV_CYCLES = 2,        // cycle cap exhausted
  RV_ERR_PC = -1,       // pc outside the program
  RV_ERR_MEM = -2,      // access outside the dense memory window
  RV_ERR_ALIGN = -3,    // misaligned word/half access
};

extern "C" int rv32_run(
    // decoded program, dense-indexed by (pc - text_base) / 4
    const uint8_t* op, const uint8_t* rd, const uint8_t* rs1,
    const uint8_t* rs2, const int32_t* imm, int64_t n_instr,
    uint32_t text_base,
    // dense word memory covering word addresses [mem_base_w, mem_base_w+n_words)
    uint32_t* mem, int64_t n_words, int64_t mem_base_w,
    // register file (32) and pc, in/out
    uint32_t* regs, uint32_t* pc_io,
    // limits: stop BEFORE an instruction that would exceed max_rows
    int64_t max_rows, int64_t max_cycles,
    // optional per-cycle capture (pass nulls to skip); capacity >= max_cycles
    uint32_t* t_pc, uint8_t* t_rd, uint32_t* t_rdv, uint32_t* t_mwa,
    uint32_t* t_mold, uint32_t* t_mnew, uint8_t* t_mfl,
    int64_t* out_cycles, int64_t* out_rows) {
  uint32_t pc = *pc_io;
  int64_t rows = 0, cycles = 0;
  const bool cap = t_pc != nullptr;
  int rc = RV_CYCLES;
  regs[0] = 0;
  while (cycles < max_cycles) {
    int64_t idx = ((int64_t)pc - (int64_t)text_base) >> 2;
    if (idx < 0 || idx >= n_instr || (pc & 3u)) { rc = RV_ERR_PC; break; }
    uint8_t o = op[idx];
    // gap slots (rv32_native.pack_program fills unmapped pcs with 255):
    // a jump into an inter-instruction gap is an undecodable pc, exactly
    // like one outside [text_base, end) — the Python authority raises
    if (o > OP_FENCE) { rc = RV_ERR_PC; break; }
    int64_t cost = (o == OP_SB || o == OP_SH) ? 2 : 1;
    if (o == OP_ECALL) { rc = RV_HALTED; break; }
    if (rows + cost > max_rows) { rc = RV_ROWS; break; }
    uint32_t a = regs[rs1[idx]], b = regs[rs2[idx]];
    int32_t im = imm[idx];
    uint32_t npc = pc + 4, val = 0;
    bool wr = false;
    uint32_t mwa = 0, mold = 0, mnew = 0;
    uint8_t mfl = 0;  // 0 none, 1 load, 2 store
    switch (o) {
      case OP_ADD: val = a + b; wr = true; break;
      case OP_ADDI: val = a + (uint32_t)im; wr = true; break;
      case OP_SUB: val = a - b; wr = true; break;
      case OP_AND: val = a & b; wr = true; break;
      case OP_ANDI: val = a & (uint32_t)im; wr = true; break;
      case OP_OR: val = a | b; wr = true; break;
      case OP_ORI: val = a | (uint32_t)im; wr = true; break;
      case OP_XOR: val = a ^ b; wr = true; break;
      case OP_XORI: val = a ^ (uint32_t)im; wr = true; break;
      case OP_SLL: val = a << (b & 31u); wr = true; break;
      case OP_SLLI: val = a << ((uint32_t)im & 31u); wr = true; break;
      case OP_SRL: val = a >> (b & 31u); wr = true; break;
      case OP_SRLI: val = a >> ((uint32_t)im & 31u); wr = true; break;
      case OP_SRA: val = (uint32_t)((int32_t)a >> (b & 31u)); wr = true; break;
      case OP_SRAI:
        val = (uint32_t)((int32_t)a >> ((uint32_t)im & 31u));
        wr = true;
        break;
      case OP_SLT: val = (int32_t)a < (int32_t)b; wr = true; break;
      case OP_SLTI: val = (int32_t)a < im; wr = true; break;
      case OP_SLTU: val = a < b; wr = true; break;
      case OP_SLTIU: val = a < (uint32_t)im; wr = true; break;
      case OP_MUL: val = a * b; wr = true; break;
      case OP_MULHU:
        val = (uint32_t)(((uint64_t)a * (uint64_t)b) >> 32);
        wr = true;
        break;
      case OP_MULH:
        val = (uint32_t)(((int64_t)(int32_t)a * (int64_t)(int32_t)b) >> 32);
        wr = true;
        break;
      case OP_MULHSU:
        val = (uint32_t)(((int64_t)(int32_t)a * (int64_t)(uint64_t)b) >> 32);
        wr = true;
        break;
      case OP_DIVU: val = b ? a / b : 0xFFFFFFFFu; wr = true; break;
      case OP_REMU: val = b ? a % b : a; wr = true; break;
      case OP_DIV: {
        int32_t sa = (int32_t)a, sb = (int32_t)b;
        if (b == 0) val = 0xFFFFFFFFu;
        else if (sa == INT32_MIN && sb == -1) val = a;
        else val = (uint32_t)(sa / sb);  // C++11 truncates toward zero = spec
        wr = true;
        break;
      }
      case OP_REM: {
        int32_t sa = (int32_t)a, sb = (int32_t)b;
        if (b == 0) val = a;
        else if (sa == INT32_MIN && sb == -1) val = 0;
        else val = (uint32_t)(sa % sb);
        wr = true;
        break;
      }
      case OP_LUI: val = (uint32_t)im; wr = true; break;
      case OP_AUIPC: val = pc + (uint32_t)im; wr = true; break;
      case OP_JAL: val = npc; npc = pc + (uint32_t)im; wr = true; break;
      case OP_JALR:
        val = npc;
        npc = (a + (uint32_t)im) & ~1u;
        wr = true;
        break;
      case OP_BEQ: if (a == b) npc = pc + (uint32_t)im; break;
      case OP_BNE: if (a != b) npc = pc + (uint32_t)im; break;
      case OP_BLT: if ((int32_t)a < (int32_t)b) npc = pc + (uint32_t)im; break;
      case OP_BGE: if ((int32_t)a >= (int32_t)b) npc = pc + (uint32_t)im; break;
      case OP_BLTU: if (a < b) npc = pc + (uint32_t)im; break;
      case OP_BGEU: if (a >= b) npc = pc + (uint32_t)im; break;
      case OP_LB: case OP_LH: case OP_LW: case OP_LBU: case OP_LHU: {
        uint32_t addr = a + (uint32_t)im;
        int64_t wa = (int64_t)(addr >> 2) - mem_base_w;
        uint32_t off = addr & 3u;
        if (wa < 0 || wa >= n_words) { rc = RV_ERR_MEM; goto done; }
        uint32_t w = mem[wa];
        if (o == OP_LW) {
          if (off) { rc = RV_ERR_ALIGN; goto done; }
          val = w;
        } else if (o == OP_LB || o == OP_LBU) {
          uint32_t byte = (w >> (8 * off)) & 0xFFu;
          val = (o == OP_LBU) ? byte
                              : (uint32_t)(int32_t)(int8_t)(uint8_t)byte;
        } else {
          if (off & 1u) { rc = RV_ERR_ALIGN; goto done; }
          uint32_t half = (w >> (8 * off)) & 0xFFFFu;
          val = (o == OP_LHU) ? half
                              : (uint32_t)(int32_t)(int16_t)(uint16_t)half;
        }
        mwa = addr >> 2; mold = w; mnew = w; mfl = 1;
        wr = true;
        break;
      }
      case OP_SB: case OP_SH: case OP_SW: {
        uint32_t addr = a + (uint32_t)im;
        int64_t wa = (int64_t)(addr >> 2) - mem_base_w;
        uint32_t off = addr & 3u;
        if (wa < 0 || wa >= n_words) { rc = RV_ERR_MEM; goto done; }
        uint32_t old = mem[wa], nw;
        if (o == OP_SW) {
          if (off) { rc = RV_ERR_ALIGN; goto done; }
          nw = b;
        } else if (o == OP_SB) {
          uint32_t sh = 8 * off;
          nw = (old & ~(0xFFu << sh)) | ((b & 0xFFu) << sh);
        } else {
          if (off & 1u) { rc = RV_ERR_ALIGN; goto done; }
          uint32_t sh = 8 * off;
          nw = (old & ~(0xFFFFu << sh)) | ((b & 0xFFFFu) << sh);
        }
        mem[wa] = nw;
        mwa = addr >> 2; mold = old; mnew = nw; mfl = 2;
        break;
      }
      case OP_ECALL: break;  // unreachable (handled above)
      case OP_FENCE: break;
      default: break;
    }
    uint8_t dst = rd[idx];
    if (wr && dst != 0) regs[dst] = val;
    if (cap) {
      t_pc[cycles] = pc;
      t_rd[cycles] = (wr && dst != 0) ? dst : 0;
      t_rdv[cycles] = (wr && dst != 0) ? val : 0;
      t_mwa[cycles] = mwa;
      t_mold[cycles] = mold;
      t_mnew[cycles] = mnew;
      t_mfl[cycles] = mfl;
    }
    pc = npc;
    rows += cost;
    cycles += 1;
  }
done:
  *pc_io = pc;
  *out_cycles = cycles;
  *out_rows = rows;
  return rc;
}
