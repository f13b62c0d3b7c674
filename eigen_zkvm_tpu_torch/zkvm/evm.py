"""EVM state-transition guest: prove the reference's reth.block.json.

The reference's flagship zkVM workload executes an Ethereum state test
(zkvm/test-vectors/reth.block.json) inside the guest via revm
(reference zkvm/program/evm/src/lib.rs:31-120, zkvm/src/lib.rs:168-186)
and proves the run with continuations.  This module is the native
counterpart: the EIP-1559 state transition — intrinsic-gas computation,
effective-gas-price selection, nonce/balance validity checks, and the
256-bit balance updates for sender/recipient/coinbase — runs as an RV32IM
guest (real machine encodings, zkvm/rv32_isa.py) over a word-packed
account RAM image, and the run is proven across chunks with the incoming/
outgoing RAM-image Poseidon digests chained as publics
(zkvm/continuations.py).  The host only packs the pre-state and unpacks
the post-state; every balance add/sub/compare and the gas arithmetic is
32-bit-limb guest code whose trace the machine PIL constrains.

256-bit values live in RAM as 8 little-endian u32 limbs.  The guest
implements add256/sub256/cmp256 carry chains with `sltu` and a 64x64->128
`mul`/`mulhu` product for gas*price fees — the same decomposition the TPU
Goldilocks engine uses (ops/gl_jax.py), here at the ISA level.

Scope: value-transfer transactions (recipient code empty), the exact
shape of the reference's test vector.  Bytecode-executing calls run
through the EVM interpreter guest (zkvm/guests.py EVM / EVM256).

Copy of eigen_zkvm_tpu/zkvm/evm.py for the PyTorch port: `prove_evm256`
and `prove_state_test` prove on `device` (None: the current CUDA device,
raising without one; "cpu" is the explicit CPU path); a `prof`
(utils/profiler.Prof) gets rv32_execute_and_prove's ticks."""
from __future__ import annotations

import json

import numpy as np

# ---- RAM image layout (word addresses; byte addr = 4 * word) ----
# 0   n_accounts
# 1   sender account index      2  to index        3  coinbase index
# 4   tx nonce (u32)
# 5,6 gas_limit (u64 lo,hi)     7,8  base_fee      9,10 max_fee
# 11,12 max_priority_fee (tip)
# 13  status (guest-written: 1 ok, 2 bad nonce, 3 insufficient funds,
#     4 gas limit below intrinsic)
# 14,15 gas_used (u64, guest-written)
# 16..23  tx value (256-bit, 8 LE limbs)
# 24  n_calldata_bytes
# 32 + 12*i .. +11   account i: nonce (u64), balance (8 limbs), 2 reserved
# 96..103  scratch 256-bit accumulator (byte 384)
# 104..126 calldata bytes, packed 4 per word (byte 416..)
HEADER_STATUS_B = 52
HEADER_GASUSED_B = 56
VALUE_B = 64
ACCT_W = 12
ACCT_BASE_B = 128
SCRATCH_B = 384
CALLDATA_B = 416
RAM_WORDS = 128
MAX_CALLDATA = (RAM_WORDS * 4) - CALLDATA_B

STATUS_OK = 1
STATUS_BAD_NONCE = 2
STATUS_INSUFFICIENT = 3
STATUS_GAS_LIMIT = 4

# The guest.  Registers: s2 intrinsic gas, s3/s4/s5 sender/to/coinbase
# account byte bases, s6/s7 effective gas price (u64), s8/s9 actual tip.
TRANSFER_GUEST = f"""
    # ---- intrinsic gas: 21000 + 16 per nonzero calldata byte, 4 per zero
    lw   t0, 96(zero)          # n_calldata_bytes
    li   t1, 0
    li   s2, 21000
intr:
    beq  t1, t0, intr_done
    addi t2, t1, {CALLDATA_B}
    lbu  t3, 0(t2)
    li   t4, 4
    beq  t3, zero, zbyte
    li   t4, 16
zbyte:
    add  s2, s2, t4
    addi t1, t1, 1
    j    intr
intr_done:
    # ---- gas_limit >= intrinsic (gas_limit u64, intrinsic fits u32)
    lw   t0, 20(zero)
    lw   t1, 24(zero)
    bne  t1, zero, gas_ok
    bgeu t0, s2, gas_ok
    li   t2, {STATUS_GAS_LIMIT}
    sw   t2, {HEADER_STATUS_B}(zero)
    ecall
gas_ok:
    # ---- effective price = min(max_fee, base_fee + tip)   (u64)
    lw   t0, 28(zero)          # base lo
    lw   t1, 32(zero)          # base hi
    lw   t2, 44(zero)          # tip lo
    lw   t3, 48(zero)          # tip hi
    add  t4, t0, t2
    sltu t5, t4, t0
    add  t6, t1, t3
    add  t6, t6, t5            # t4/t6 = base + tip
    lw   a2, 36(zero)          # max_fee lo
    lw   a3, 40(zero)          # max_fee hi
    bltu a3, t6, use_max
    bne  a3, t6, use_sum
    bltu a2, t4, use_max
use_sum:
    mv   a2, t4
    mv   a3, t6
use_max:
    mv   s6, a2
    mv   s7, a3
    # actual tip = eff - base_fee
    sltu t5, s6, t0
    sub  s8, s6, t0
    sub  s9, s7, t1
    sub  s9, s9, t5
    # ---- account byte bases
    li   t1, {4 * ACCT_W}
    lw   t0, 4(zero)
    mul  t0, t0, t1
    addi s3, t0, {ACCT_BASE_B}
    lw   t0, 8(zero)
    mul  t0, t0, t1
    addi s4, t0, {ACCT_BASE_B}
    lw   t0, 12(zero)
    mul  t0, t0, t1
    addi s5, t0, {ACCT_BASE_B}
    # ---- nonce check: sender.nonce == tx.nonce (u64 vs u32)
    lw   t0, 0(s3)
    lw   t1, 4(s3)
    lw   t2, 16(zero)
    bne  t1, zero, bad_nonce
    beq  t0, t2, nonce_ok
bad_nonce:
    li   t2, {STATUS_BAD_NONCE}
    sw   t2, {HEADER_STATUS_B}(zero)
    ecall
nonce_ok:
    # ---- upfront cost = value + gas_limit * max_fee   -> scratch
    lw   a0, 20(zero)
    lw   a1, 24(zero)
    lw   a2, 36(zero)
    lw   a3, 40(zero)
    jal  ra, mulu64
    jal  ra, store_prod
    li   a0, {SCRATCH_B}
    li   a1, {VALUE_B}
    jal  ra, add256
    # sender.balance < upfront  -> insufficient
    addi a0, s3, 8
    li   a1, {SCRATCH_B}
    jal  ra, cmp256
    beq  a2, zero, funds_ok
    li   t2, {STATUS_INSUFFICIENT}
    sw   t2, {HEADER_STATUS_B}(zero)
    ecall
funds_ok:
    # ---- gas_used = intrinsic (pure transfer; no code at recipient)
    sw   s2, {HEADER_GASUSED_B}(zero)
    sw   zero, {HEADER_GASUSED_B + 4}(zero)
    # fee = gas_used * eff  -> scratch
    mv   a0, s2
    li   a1, 0
    mv   a2, s6
    mv   a3, s7
    jal  ra, mulu64
    jal  ra, store_prod
    # sender.balance -= value ; -= fee ; nonce += 1
    addi a0, s3, 8
    li   a1, {VALUE_B}
    jal  ra, sub256
    addi a0, s3, 8
    li   a1, {SCRATCH_B}
    jal  ra, sub256
    lw   t0, 0(s3)
    addi t0, t0, 1
    sw   t0, 0(s3)
    bne  t0, zero, nonce_done
    lw   t1, 4(s3)
    addi t1, t1, 1
    sw   t1, 4(s3)
nonce_done:
    # to.balance += value
    addi a0, s4, 8
    li   a1, {VALUE_B}
    jal  ra, add256
    # coinbase.balance += gas_used * actual_tip
    mv   a0, s2
    li   a1, 0
    mv   a2, s8
    mv   a3, s9
    jal  ra, mulu64
    jal  ra, store_prod
    addi a0, s5, 8
    li   a1, {SCRATCH_B}
    jal  ra, add256
    li   t2, {STATUS_OK}
    sw   t2, {HEADER_STATUS_B}(zero)
    ecall

    # ---- subroutines (leaf calls only; ra is live across none of them)
    # mulu64: (a0,a1) * (a2,a3) -> 128-bit product in a4..a7
mulu64:
    mul   a4, a0, a2
    mulhu a5, a0, a2
    mul   t0, a0, a3
    mulhu t1, a0, a3
    mul   t2, a1, a2
    mulhu t3, a1, a2
    mul   a6, a1, a3
    mulhu a7, a1, a3
    add  a5, a5, t0
    sltu t4, a5, t0
    add  a6, a6, t4
    sltu t5, a6, t4
    add  a7, a7, t5
    add  a5, a5, t2
    sltu t4, a5, t2
    add  a6, a6, t4
    sltu t5, a6, t4
    add  a7, a7, t5
    add  a6, a6, t1
    sltu t4, a6, t1
    add  a7, a7, t4
    add  a6, a6, t3
    sltu t4, a6, t3
    add  a7, a7, t4
    ret
    # store_prod: scratch = zero-extended a4..a7
store_prod:
    sw   a4, {SCRATCH_B}(zero)
    sw   a5, {SCRATCH_B + 4}(zero)
    sw   a6, {SCRATCH_B + 8}(zero)
    sw   a7, {SCRATCH_B + 12}(zero)
    sw   zero, {SCRATCH_B + 16}(zero)
    sw   zero, {SCRATCH_B + 20}(zero)
    sw   zero, {SCRATCH_B + 24}(zero)
    sw   zero, {SCRATCH_B + 28}(zero)
    ret
    # add256: [a0] += [a1]   (8 u32 limbs, sltu carry chain)
add256:
    li   t0, 0
    li   t1, 0
addl:
    add  t2, a0, t0
    lw   t3, 0(t2)
    add  t4, a1, t0
    lw   t5, 0(t4)
    add  t6, t3, t5
    sltu t5, t6, t5
    add  t6, t6, t1
    sltu t4, t6, t1
    or   t1, t5, t4
    sw   t6, 0(t2)
    addi t0, t0, 4
    li   t2, 32
    bne  t0, t2, addl
    ret
    # sub256: [a0] -= [a1]; borrow out in a2
sub256:
    li   t0, 0
    li   t1, 0
subl:
    add  t2, a0, t0
    lw   t3, 0(t2)
    add  t4, a1, t0
    lw   t5, 0(t4)
    sltu t6, t3, t5
    sub  t3, t3, t5
    sltu t4, t3, t1
    sub  t3, t3, t1
    or   t1, t6, t4
    sw   t3, 0(t2)
    addi t0, t0, 4
    li   t2, 32
    bne  t0, t2, subl
    mv   a2, t1
    ret
    # cmp256: a2 = 1 if [a0] < [a1] else 0   (top limb down)
cmp256:
    li   t0, 28
cmpl:
    add  t2, a0, t0
    lw   t3, 0(t2)
    add  t4, a1, t0
    lw   t5, 0(t4)
    bltu t3, t5, cmp_lt
    bltu t5, t3, cmp_ge
    beq  t0, zero, cmp_ge
    addi t0, t0, -4
    j    cmpl
cmp_lt:
    li   a2, 1
    ret
cmp_ge:
    li   a2, 0
    ret
"""


# ---------------------------------------------------------------------------
# EVM bytecode interpreter with TRUE 256-bit words (8 u32 limbs per stack
# slot), the reference program/evm's interpreter role.  Image layout:
#   word 0          n_code_bytes
#   byte 4          status (1 = clean stop, 3 = bad jump target)
#   bytes 32..63    result = final stack top (zero if stack empty)
#   bytes 64..319   bytecode (1 byte per byte, implicit zero padding past
#                   the end — EVM semantics for PUSH over the code end)
#   bytes 448..479  256-bit MUL scratch accumulator
#   bytes 512..1023 the EVM stack, 16 slots x 32 bytes, grows up
# Opcodes: STOP ADD MUL SUB LT GT EQ ISZERO AND OR XOR NOT POP JUMP JUMPI
# PC JUMPDEST PUSH1..PUSH32 DUP1..DUP16 SWAP1..SWAP16; unknown = STOP;
# JUMP/JUMPI validate the target byte is a JUMPDEST (status 3 otherwise).
EVM_CODE_B = 64
EVM_SCRATCH_B = 448
EVM_STACK_B = 512
EVM_STACK_END = 1024
EVM_RESULT_B = 32
EVM_RAM_WORDS = 256
EVM_MAX_CODE = EVM_SCRATCH_B - EVM_CODE_B

EVM256_GUEST = f"""
    lw   s2, 0(zero)           # n_code_bytes
    li   s0, 0                 # evm pc
    li   s1, {EVM_STACK_B}     # sp (next free slot, byte addr)
run:
    bgeu s0, s2, op_stop       # ran off the code end
    addi t0, s0, {EVM_CODE_B}
    lbu  t1, 0(t0)
    addi s0, s0, 1
    li   t2, 0x60
    bltu t1, t2, low
    li   t2, 0x80
    bltu t1, t2, op_push
    li   t2, 0x90
    bltu t1, t2, op_dup
    li   t2, 0xa0
    bltu t1, t2, op_swap
    j    op_stop
low:
    beq  t1, zero, op_stop
    li   t2, 0x01
    beq  t1, t2, op_add
    li   t2, 0x02
    beq  t1, t2, op_mul
    li   t2, 0x03
    beq  t1, t2, op_sub
    li   t2, 0x10
    beq  t1, t2, op_lt
    li   t2, 0x11
    beq  t1, t2, op_gt
    li   t2, 0x14
    beq  t1, t2, op_eq
    li   t2, 0x15
    beq  t1, t2, op_iszero
    li   t2, 0x16
    beq  t1, t2, op_and
    li   t2, 0x17
    beq  t1, t2, op_or
    li   t2, 0x18
    beq  t1, t2, op_xor
    li   t2, 0x19
    beq  t1, t2, op_not
    li   t2, 0x50
    beq  t1, t2, op_pop
    li   t2, 0x56
    beq  t1, t2, op_jump
    li   t2, 0x57
    beq  t1, t2, op_jumpi
    li   t2, 0x58
    beq  t1, t2, op_pcop
    li   t2, 0x5b
    beq  t1, t2, run           # JUMPDEST: no-op
    j    op_stop

op_push:                       # t1 = 0x60..0x7f -> n = t1 - 0x5f bytes
    li   t5, {EVM_STACK_END}
    bgeu s1, t5, op_stop       # stack overflow
    addi t3, t1, -0x5f
    mv   a0, s1
    jal  ra, zero256
    li   t4, 0                 # i
pushl:
    beq  t4, t3, pushd
    add  t5, s0, t4
    addi t5, t5, {EVM_CODE_B}
    lbu  t6, 0(t5)             # big-endian source byte i
    sub  t5, t3, t4
    addi t5, t5, -1            # little-endian dest byte n-1-i
    add  t5, t5, s1
    sb   t6, 0(t5)
    addi t4, t4, 1
    j    pushl
pushd:
    add  s0, s0, t3
    addi s1, s1, 32
    j    run

op_dup:                        # t1 = 0x80..0x8f -> k = t1 - 0x7f
    li   t5, {EVM_STACK_END}
    bgeu s1, t5, op_stop
    addi t3, t1, -0x7f
    slli t3, t3, 5
    sub  a1, s1, t3
    mv   a0, s1
    jal  ra, copy256
    addi s1, s1, 32
    j    run

op_swap:                       # t1 = 0x90..0x9f -> k = t1 - 0x8f
    addi t3, t1, -0x8f
    slli t3, t3, 5
    addi a0, s1, -32
    sub  a1, a0, t3
    li   t4, 0
swapl:
    add  t5, a0, t4
    lw   t6, 0(t5)
    add  t2, a1, t4
    lw   t1, 0(t2)
    sw   t1, 0(t5)
    sw   t6, 0(t2)
    addi t4, t4, 4
    li   t5, 32
    bne  t4, t5, swapl
    j    run

op_add:                        # [sp-64] = a + b (a = top)
    addi a0, s1, -64
    addi a1, s1, -32
    jal  ra, add256
    addi s1, s1, -32
    j    run
op_sub:                        # result = top - second
    addi a0, s1, -64
    addi a1, s1, -32
    jal  ra, rsub256
    addi s1, s1, -32
    j    run
op_mul:
    li   a0, {EVM_SCRATCH_B}
    jal  ra, zero256
    li   t0, 0                 # i (byte offset into A = top)
mull_i:
    li   t1, 32
    beq  t0, t1, mul_done
    addi t2, s1, -32
    add  t2, t2, t0
    lw   a0, 0(t2)             # A[i]
    beq  a0, zero, mul_next
    li   t1, 0                 # j
    li   t3, 0                 # carry
mull_j:
    add  t4, t0, t1
    li   t5, 32
    bgeu t4, t5, mul_next      # past limb 7: product/carry discarded mod 2^256
    addi t2, s1, -64
    add  t2, t2, t1
    lw   a1, 0(t2)             # B[j]
    mul  t5, a0, a1
    mulhu t6, a0, a1
    li   t2, {EVM_SCRATCH_B}
    add  t2, t2, t4
    lw   a2, 0(t2)
    add  a2, a2, t5
    sltu t5, a2, t5
    add  a2, a2, t3
    sltu t3, a2, t3
    add  t3, t3, t5
    add  t3, t3, t6            # carry' = hi + c1 + c2 (provably < 2^32)
    sw   a2, 0(t2)
    addi t1, t1, 4
    j    mull_j
mul_next:
    addi t0, t0, 4
    j    mull_i
mul_done:
    addi a0, s1, -64
    li   a1, {EVM_SCRATCH_B}
    jal  ra, copy256
    addi s1, s1, -32
    j    run

op_lt:                         # 1 if top < second
    addi a0, s1, -32
    addi a1, s1, -64
    jal  ra, cmp256
    j    cmp_fin
op_gt:
    addi a0, s1, -64
    addi a1, s1, -32
    jal  ra, cmp256
    j    cmp_fin
op_eq:
    addi a0, s1, -32
    addi a1, s1, -64
    jal  ra, eq256
cmp_fin:
    addi a0, s1, -64
    mv   s3, a2
    jal  ra, zero256
    sw   s3, -64(s1)
    addi s1, s1, -32
    j    run
op_iszero:
    addi a0, s1, -32
    jal  ra, isz256
    addi a0, s1, -32
    mv   s3, a2
    jal  ra, zero256
    sw   s3, -32(s1)
    j    run

op_and:
    li   t6, 0                 # 0 = and
    j    logic
op_or:
    li   t6, 1
    j    logic
op_xor:
    li   t6, 2
logic:
    li   t4, 0
logicl:
    addi t2, s1, -32
    add  t2, t2, t4
    lw   t3, 0(t2)             # a limb
    addi t2, s1, -64
    add  t2, t2, t4
    lw   t5, 0(t2)             # b limb
    beq  t6, zero, do_and
    li   t0, 1
    beq  t6, t0, do_or
    xor  t3, t3, t5
    j    logic_w
do_and:
    and  t3, t3, t5
    j    logic_w
do_or:
    or   t3, t3, t5
logic_w:
    sw   t3, 0(t2)
    addi t4, t4, 4
    li   t0, 32
    bne  t4, t0, logicl
    addi s1, s1, -32
    j    run
op_not:
    li   t4, 0
    addi t6, zero, -1
notl:
    addi t2, s1, -32
    add  t2, t2, t4
    lw   t3, 0(t2)
    xor  t3, t3, t6
    sw   t3, 0(t2)
    addi t4, t4, 4
    li   t0, 32
    bne  t4, t0, notl
    j    run

op_pop:
    addi s1, s1, -32
    j    run
op_jump:
    addi s1, s1, -32
    lw   t0, 0(s1)             # dest (low limb; high limbs out of range)
    j    jump_to
op_jumpi:
    addi s1, s1, -32
    lw   t0, 0(s1)             # dest
    addi s1, s1, -32
    mv   a0, s1
    jal  ra, isz256            # cond == 0 ?
    bne  a2, zero, run
jump_to:
    bgeu t0, s2, bad_jump
    addi t1, t0, {EVM_CODE_B}
    lbu  t2, 0(t1)
    li   t3, 0x5b
    bne  t2, t3, bad_jump
    mv   s0, t0
    j    run
bad_jump:
    li   t0, 3
    sw   t0, 4(zero)
    ecall
op_pcop:
    li   t5, {EVM_STACK_END}
    bgeu s1, t5, op_stop
    mv   a0, s1
    jal  ra, zero256
    addi t0, s0, -1            # PC pushes its own address
    sw   t0, 0(s1)
    addi s1, s1, 32
    j    run

op_stop:
    li   t0, {EVM_STACK_B}
    bgeu t0, s1, no_result
    addi a1, s1, -32
    li   a0, {EVM_RESULT_B}
    jal  ra, copy256
no_result:
    li   t0, 1
    sw   t0, 4(zero)
    ecall

    # ---- 256-bit subroutines (leaf; t-regs scratch, a2 result) ----
zero256:                       # [a0] = 0
    li   t5, 0
zl:
    add  t6, a0, t5
    sw   zero, 0(t6)
    addi t5, t5, 4
    li   t6, 32
    bne  t5, t6, zl
    ret
copy256:                       # [a0] = [a1]
    li   t4, 0
cl:
    add  t5, a1, t4
    lw   t6, 0(t5)
    add  t5, a0, t4
    sw   t6, 0(t5)
    addi t4, t4, 4
    li   t5, 32
    bne  t4, t5, cl
    ret
eq256:                         # a2 = ([a0] == [a1])
    li   t4, 0
eql:
    add  t5, a0, t4
    lw   t6, 0(t5)
    add  t5, a1, t4
    lw   t3, 0(t5)
    bne  t6, t3, eq_no
    addi t4, t4, 4
    li   t5, 32
    bne  t4, t5, eql
    li   a2, 1
    ret
eq_no:
    li   a2, 0
    ret
isz256:                        # a2 = ([a0] == 0); preserves t0
    li   t4, 0
il:
    add  t5, a0, t4
    lw   t6, 0(t5)
    bne  t6, zero, isz_no
    addi t4, t4, 4
    li   t5, 32
    bne  t4, t5, il
    li   a2, 1
    ret
isz_no:
    li   a2, 0
    ret
rsub256:                       # [a0] = [a1] - [a0]  (borrow discarded mod 2^256)
    li   t0, 0
    li   t1, 0
rsl:
    add  t2, a1, t0
    lw   t3, 0(t2)             # minuend
    add  t4, a0, t0
    lw   t5, 0(t4)             # subtrahend
    sltu t6, t3, t5
    sub  t3, t3, t5
    sltu t2, t3, t1
    sub  t3, t3, t1
    or   t1, t6, t2
    sw   t3, 0(t4)
    addi t0, t0, 4
    li   t2, 32
    bne  t0, t2, rsl
    ret
add256:                        # [a0] += [a1]  (carry discarded mod 2^256)
    li   t0, 0
    li   t1, 0
addl:
    add  t2, a0, t0
    lw   t3, 0(t2)
    add  t4, a1, t0
    lw   t5, 0(t4)
    add  t6, t3, t5
    sltu t5, t6, t5
    add  t6, t6, t1
    sltu t4, t6, t1
    or   t1, t5, t4
    sw   t6, 0(t2)
    addi t0, t0, 4
    li   t2, 32
    bne  t0, t2, addl
    ret
cmp256:                        # a2 = ([a0] < [a1]), top limb down
    li   t0, 28
cmpl:
    add  t2, a0, t0
    lw   t3, 0(t2)
    add  t4, a1, t0
    lw   t5, 0(t4)
    bltu t3, t5, cmp_lt
    bltu t5, t3, cmp_ge
    beq  t0, zero, cmp_ge
    addi t0, t0, -4
    j    cmpl
cmp_lt:
    li   a2, 1
    ret
cmp_ge:
    li   a2, 0
    ret
"""


U256 = (1 << 256) - 1


def build_evm256_image(code: bytes):
    """Pack EVM bytecode into the interpreter guest's RAM image."""
    assert len(code) <= EVM_MAX_CODE, "bytecode exceeds the code area"
    img = np.zeros(EVM_RAM_WORDS, dtype=np.uint64)
    img[0] = len(code)
    for i, b in enumerate(code):
        w = (EVM_CODE_B // 4) + (i // 4)
        img[w] = int(img[w]) | (b << (8 * (i % 4)))
    return img


def evm256_reference(code: bytes, max_steps: int = 100_000):
    """Pure-python 256-bit EVM model of the guest's opcode subset
    (differential oracle).  Returns (result_or_None, status)."""
    stack: list[int] = []
    pc = 0
    for _ in range(max_steps):
        if pc >= len(code):
            break
        op = code[pc]
        pc += 1
        if 0x60 <= op <= 0x7F:
            n = op - 0x5F
            v = int.from_bytes(code[pc : pc + n].ljust(n, b"\0"), "big")
            stack.append(v)
            pc += n
        elif 0x80 <= op <= 0x8F:
            stack.append(stack[-(op - 0x7F)])
        elif 0x90 <= op <= 0x9F:
            k = op - 0x8F
            stack[-1], stack[-1 - k] = stack[-1 - k], stack[-1]
        elif op == 0x01:
            a, b = stack.pop(), stack.pop()
            stack.append((a + b) & U256)
        elif op == 0x02:
            a, b = stack.pop(), stack.pop()
            stack.append((a * b) & U256)
        elif op == 0x03:
            a, b = stack.pop(), stack.pop()
            stack.append((a - b) & U256)
        elif op == 0x10:
            a, b = stack.pop(), stack.pop()
            stack.append(1 if a < b else 0)
        elif op == 0x11:
            a, b = stack.pop(), stack.pop()
            stack.append(1 if a > b else 0)
        elif op == 0x14:
            a, b = stack.pop(), stack.pop()
            stack.append(1 if a == b else 0)
        elif op == 0x15:
            stack.append(1 if stack.pop() == 0 else 0)
        elif op == 0x16:
            a, b = stack.pop(), stack.pop()
            stack.append(a & b)
        elif op == 0x17:
            a, b = stack.pop(), stack.pop()
            stack.append(a | b)
        elif op == 0x18:
            a, b = stack.pop(), stack.pop()
            stack.append(a ^ b)
        elif op == 0x19:
            stack.append(stack.pop() ^ U256)
        elif op == 0x50:
            stack.pop()
        elif op in (0x56, 0x57):
            dest = stack.pop()
            cond = stack.pop() if op == 0x57 else 1
            if cond:
                if dest >= len(code) or code[dest] != 0x5B:
                    return (stack[-1] if stack else None), 3
                pc = dest
        elif op == 0x58:
            stack.append(pc - 1)
        elif op == 0x5B:
            pass
        else:  # STOP / unimplemented
            break
    return (stack[-1] if stack else None), 1


def run_evm256(code: bytes):
    """Execute the interpreter guest on `code` (no proving).  Returns
    (result_or_None, status, final_image, n_cycles)."""
    from .rv32_isa import execute
    from .rv32_lib import program_from_asm

    img = build_evm256_image(code)
    mem = {a: int(v) for a, v in enumerate(img) if v}
    states, final = execute(program_from_asm(EVM256_GUEST), 0, mem=mem)
    assert final.halted, "interpreter did not halt"
    fi = np.zeros(EVM_RAM_WORDS, dtype=np.uint64)
    for a, v in mem.items():
        fi[a] = v
    status = int(fi[1])
    rbase = EVM_RESULT_B // 4
    result = _unlimbs(fi[rbase : rbase + 8])
    had_result = any(int(v) for v in fi[rbase : rbase + 8])
    return (result if had_result else None), status, fi, len(states)


def prove_evm256(code: bytes, n_bits: int = 12, n_queries: int = 2,
                 rows_budget: int | None = None, device=None, prof=None):
    """Prove an EVM bytecode execution end to end on `device`: the
    interpreter guest runs the code with 256-bit words, the run is proven
    across chunks with chained RAM-image digests, and the result is
    differentially checked against the python EVM model."""
    from .machine import ram_digest
    from .rv32_lib import rv32_execute_and_prove

    image0 = build_evm256_image(code)
    result, status, final_image, _ = run_evm256(code)
    ref_result, ref_status = evm256_reference(code)
    assert status == ref_status, "guest status disagrees with the EVM model"
    if status == STATUS_OK and ref_result is not None:
        assert result == ref_result, "guest result disagrees with the model"
    proofs, publics_list, machine, setup, ss = rv32_execute_and_prove(
        EVM256_GUEST, n_bits=n_bits, ram_words=EVM_RAM_WORDS, image0=image0,
        n_queries=n_queries, rows_budget=rows_budget, device=device,
        prof=prof)
    d_out = ram_digest(final_image)
    for j in range(4):
        assert publics_list[-1][f"mem_out{j}"] == d_out[j], \
            "final image digest mismatch"
    return {"proofs": proofs, "publics": publics_list, "result": result,
            "status": status, "machine": machine, "setup": setup, "ss": ss,
            "n_chunks": len(proofs)}


def _limbs(v: int, n: int = 8) -> list[int]:
    assert v < 1 << (32 * n), "value exceeds 256 bits"
    return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(n)]


def _unlimbs(ws) -> int:
    return sum(int(w) << (32 * i) for i, w in enumerate(ws))


def _hx(s: str) -> int:
    return int(s, 16)


def load_state_test(path: str, fork: str = "Shanghai"):
    """Parse a reference-format Ethereum state test (reth.block.json).
    Returns (pre, env, tx, expected_post) with ints, address-keyed."""
    with open(path) as f:
        d = json.load(f)
    pre = {a.lower(): {"nonce": _hx(acc["nonce"]),
                       "balance": _hx(acc["balance"]),
                       "code": acc.get("code", "0x"),
                       "storage": acc.get("storage", {})}
           for a, acc in d["pre"].items()}
    env = d["env"]
    tx = d["transaction"]
    post = d["post"][fork][0]["postState"]
    expected = {a.lower(): {"nonce": _hx(acc["nonce"]),
                            "balance": _hx(acc["balance"])}
                for a, acc in post.items()}
    return pre, env, tx, expected


def build_image(pre: dict, env: dict, tx: dict):
    """Pack pre-state + tx into the guest RAM image.  Returns
    (image np.uint64[RAM_WORDS], addr_order list)."""
    sender = tx["sender"].lower()
    to = tx["to"].lower()
    coinbase = env["currentCoinbase"].lower()
    addrs = list(pre)
    for a in (to, coinbase):
        if a not in addrs:
            addrs.append(a)
    assert (ACCT_BASE_B // 4) + ACCT_W * len(addrs) <= SCRATCH_B // 4, \
        "too many accounts for the fixed image layout"
    for a in addrs:
        acc = pre.get(a, {"code": "0x", "storage": {}})
        assert acc["code"] in ("0x", "", "0x00"), \
            "transfer guest handles EOA recipients only"
        assert not acc["storage"], "transfer guest handles empty storage"

    data = bytes.fromhex(tx["data"][0][2:]) if tx.get("data") else b""
    assert len(data) <= MAX_CALLDATA, "calldata exceeds image area"
    base_fee = _hx(env["currentBaseFee"])
    max_fee = _hx(tx["maxFeePerGas"]) if tx.get("maxFeePerGas") \
        else _hx(tx["gasPrice"])
    tip = _hx(tx["maxPriorityFeePerGas"]) if tx.get("maxPriorityFeePerGas") \
        else max_fee
    gas_limit = _hx(tx["gasLimit"][0])
    value = _hx(tx["value"][0])

    img = np.zeros(RAM_WORDS, dtype=np.uint64)
    img[0] = len(addrs)
    img[1] = addrs.index(sender)
    img[2] = addrs.index(to)
    img[3] = addrs.index(coinbase)
    img[4] = _hx(tx["nonce"])
    img[5], img[6] = gas_limit & 0xFFFFFFFF, gas_limit >> 32
    img[7], img[8] = base_fee & 0xFFFFFFFF, base_fee >> 32
    img[9], img[10] = max_fee & 0xFFFFFFFF, max_fee >> 32
    img[11], img[12] = tip & 0xFFFFFFFF, tip >> 32
    img[16:24] = _limbs(value)
    img[24] = len(data)
    for i, b in enumerate(data):
        w = (CALLDATA_B // 4) + (i // 4)
        img[w] = int(img[w]) | (b << (8 * (i % 4)))
    for i, a in enumerate(addrs):
        acc = pre.get(a, {"nonce": 0, "balance": 0})
        base = (ACCT_BASE_B // 4) + ACCT_W * i
        img[base] = acc["nonce"] & 0xFFFFFFFF
        img[base + 1] = acc["nonce"] >> 32
        img[base + 2 : base + 10] = _limbs(acc["balance"])
    return img, addrs


def unpack_post(image, addrs):
    """Extract {addr: {nonce, balance}}, status and gas_used from the
    final RAM image."""
    out = {}
    for i, a in enumerate(addrs):
        base = (ACCT_BASE_B // 4) + ACCT_W * i
        out[a] = {"nonce": _unlimbs(image[base : base + 2]),
                  "balance": _unlimbs(image[base + 2 : base + 10])}
    status = int(image[HEADER_STATUS_B // 4])
    gas_used = _unlimbs(image[HEADER_GASUSED_B // 4 : HEADER_GASUSED_B // 4 + 2])
    return out, status, gas_used


def apply_transaction_host(pre: dict, env: dict, tx: dict):
    """Pure-python reference model of the guest (differential check)."""
    sender, to = tx["sender"].lower(), tx["to"].lower()
    coinbase = env["currentCoinbase"].lower()
    base_fee = _hx(env["currentBaseFee"])
    max_fee = _hx(tx["maxFeePerGas"]) if tx.get("maxFeePerGas") \
        else _hx(tx["gasPrice"])
    tip = _hx(tx["maxPriorityFeePerGas"]) if tx.get("maxPriorityFeePerGas") \
        else max_fee
    gas_limit = _hx(tx["gasLimit"][0])
    value = _hx(tx["value"][0])
    data = bytes.fromhex(tx["data"][0][2:]) if tx.get("data") else b""
    intrinsic = 21000 + sum(16 if b else 4 for b in data)

    st = {a: dict(acc) for a, acc in pre.items()}
    for a in (to, coinbase):
        st.setdefault(a, {"nonce": 0, "balance": 0})
    if gas_limit < intrinsic:
        return st, STATUS_GAS_LIMIT, 0
    eff = min(max_fee, base_fee + tip)
    if st[sender]["nonce"] != _hx(tx["nonce"]):
        return st, STATUS_BAD_NONCE, 0
    if st[sender]["balance"] < value + gas_limit * max_fee:
        return st, STATUS_INSUFFICIENT, 0
    gas_used = intrinsic
    st[sender]["balance"] -= value + gas_used * eff
    st[sender]["nonce"] += 1
    st[to]["balance"] += value
    st[coinbase]["balance"] += gas_used * (eff - base_fee)
    return st, STATUS_OK, gas_used


def prove_state_test(path: str, fork: str = "Shanghai", n_bits: int = 11,
                     n_queries: int = 2, rows_budget: int | None = None,
                     device=None, prof=None):
    """Execute + prove the state test end to end on `device`.  Returns a
    dict with proofs, chunk publics, post-state, status and gas_used.

    The proof binds the transition: chunk 0's mem_in publics are the
    Poseidon digest of the packed PRE-state image, the final chunk's
    mem_out publics are the digest of the POST-state image the host
    unpacks, and every boundary handoff is chained (and provable
    in-circuit via recursion/compressor12.ChainMap)."""
    from .machine import ram_digest
    from .rv32_lib import program_from_asm, rv32_execute_and_prove
    from .rv32_isa import execute

    pre, env, tx, expected = load_state_test(path, fork)
    image0, addrs = build_image(pre, env, tx)
    program = program_from_asm(TRANSFER_GUEST)

    # host-side final image (re-execution is microseconds; the PROOF of the
    # same run comes from rv32_execute_and_prove below)
    mem = {a: int(v) for a, v in enumerate(image0) if v}
    states, final = execute(program, 0, mem=mem)
    assert final.halted, "guest did not halt"
    final_image = np.zeros(RAM_WORDS, dtype=np.uint64)
    for a, v in mem.items():
        final_image[a] = v

    proofs, publics_list, machine, setup, ss = rv32_execute_and_prove(
        program, n_bits=n_bits, ram_words=RAM_WORDS, image0=image0,
        n_queries=n_queries, rows_budget=rows_budget, device=device,
        prof=prof)

    # the proven outgoing image digest must match the unpacked post-state
    d_out = ram_digest(final_image)
    for j in range(4):
        assert publics_list[-1][f"mem_out{j}"] == d_out[j], \
            "final chunk image digest does not match the unpacked post-state"

    post, status, gas_used = unpack_post(final_image, addrs)
    host_post, host_status, host_gas = apply_transaction_host(pre, env, tx)
    assert status == host_status and gas_used == host_gas, \
        "guest transition disagrees with the host model"
    for a in addrs:
        assert post[a]["balance"] == host_post[a]["balance"], a
        assert post[a]["nonce"] == host_post[a]["nonce"], a
    if expected is not None and status == STATUS_OK:
        for a, acc in expected.items():
            assert post[a]["balance"] == acc["balance"], \
                f"balance mismatch for {a}"
            assert post[a]["nonce"] == acc["nonce"], f"nonce mismatch for {a}"
    return {"proofs": proofs, "publics": publics_list, "post": post,
            "status": status, "gas_used": gas_used, "machine": machine,
            "setup": setup, "ss": ss, "n_chunks": len(proofs)}
