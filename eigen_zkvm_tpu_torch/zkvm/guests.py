"""Example guest programs (the reference's zkvm/program/{lr,evm} analogs).

`fibonacci`: n from the input tape, computes fib(n) mod 2^32 into x3.
`linear_regression`: the reference's lr guest (program/lr/src/lib.rs):
reads n, then n (x, y) pairs from the tape, computes the OLS slope/intercept
numerators/denominator in 32-bit arithmetic:
  sxy_n = n*sum(xy) ; sx_sy = sum(x)*sum(y) ; sxx_n = n*sum(xx) ; sx2 ...
leaving  num = n*sum(xy) - sum(x)*sum(y)  in x5
and      den = n*sum(xx) - sum(x)^2       in x6  (all mod 2^32).

Copy of eigen_zkvm_tpu/zkvm/guests.py for the PyTorch port: the MiniRV
programs of the port's zkvm/isa.py."""

FIBONACCI = """
    in   x1          # n
    li   x2, 0       # a
    li   x3, 1       # b
    li   x4, 0       # i
    li   x5, 1
loop:
    beq  x4, x1, done
    add  x6, x2, x3
    mv   x2, x3
    mv   x3, x6
    add  x4, x4, x5
    j    loop
done:
    halt
"""

LINEAR_REGRESSION = """
    in   x1          # n
    li   x2, 0       # sum x
    li   x3, 0       # sum y
    li   x4, 0       # sum xy
    li   x5, 0       # sum xx
    li   x6, 0       # i
    li   x7, 1
loop:
    beq  x6, x1, fini
    in   x8          # x_i
    in   x9          # y_i
    add  x2, x2, x8
    add  x3, x3, x9
    mul  x10, x8, x9
    add  x4, x4, x10
    mul  x10, x8, x8
    add  x5, x5, x10
    add  x6, x6, x7
    j    loop
fini:
    mul  x10, x1, x4 # n*sum(xy)
    mul  x11, x2, x3 # sum(x)*sum(y)
    sub  x5, x5, x0  # keep sum xx
    mul  x12, x1, x5 # n*sum(xx)
    mul  x13, x2, x2 # sum(x)^2
    sub  x5, x10, x11  # num -> x5
    sub  x6, x12, x13  # den -> x6
    halt
"""

# gcd(a, b) by binary-free Euclid (repeated subtraction with a swap walk):
# reads a, b from the tape, leaves gcd in x2.  Exercises the branch ops
# (blt/bne) and long multi-chunk traces for small inputs.
GCD = """
    in   x2          # a
    in   x3          # b
loop:
    beq  x3, x0, done
    blt  x2, x3, swap
    sub  x2, x2, x3
    j    loop
swap:
    add  x4, x2, x0
    add  x2, x3, x0
    add  x3, x4, x0
    j    loop
done:
    halt
"""

# modular micro-exponentiation base^e mod 2^32 with a unary exponent loop:
# reads base, e; leaves the power in x3.
POW = """
    in   x1          # base
    in   x2          # e
    li   x3, 1
    li   x4, 0
    li   x5, 1
loop:
    beq  x4, x2, done
    mul  x3, x3, x1
    add  x4, x4, x5
    j    loop
done:
    halt
"""

# RAM smoke guest: stores n tape values to memory, reads them back and
# sums them into x7.  Exercises lw/sw and the sorted-memory argument
# (machine.py RAM section) end to end.
MEMSUM = """
    in   x1          # n
    li   x2, 0x100   # base
    li   x3, 0       # i
    li   x4, 1
store:
    beq  x3, x1, rd
    in   x5
    add  x6, x2, x3
    sw   x5, x6, 0
    add  x3, x3, x4
    j    store
rd:
    li   x3, 0
    li   x7, 0       # sum
load:
    beq  x3, x1, done
    add  x6, x2, x3
    lw   x5, x6, 0
    add  x7, x7, x5
    add  x3, x3, x4
    j    load
done:
    halt
"""

# EVM-subset interpreter (the reference's zkvm/program/evm analog, natively
# authored instead of compiling the rust-evm crate through powdr): executes
# EVM bytecode with one bytecode BYTE per RAM word (tape: n_code then the
# code words), a word-per-slot EVM stack at 0x2000, and leaves the final
# stack top in x10.  Implemented opcodes: STOP, ADD(0x01), MUL(0x02),
# SUB(0x03), POP(0x50), JUMPI(0x57), JUMPDEST(0x5b), PUSH1(0x60),
# DUP1(0x80), SWAP1(0x90); 32-bit word arithmetic (mod 2^32 instead of
# 2^256 — the machine word).  Unknown opcodes halt like STOP.
EVM = """
    in   x1            # n_code
    li   x2, 0x1000    # code base
    li   x3, 0         # i
    li   x7, 1
ldcode:
    beq  x3, x1, run
    in   x5
    add  x6, x2, x3
    sw   x5, x6, 0
    add  x3, x3, x7
    j    ldcode
run:
    li   x2, 0         # evm pc
    li   x3, 0x2000    # sp (next free slot)
step:
    li   x6, 0x1000
    add  x6, x6, x2
    lw   x4, x6, 0     # opcode
    add  x2, x2, x7    # pc++
    li   x5, 0x60
    beq  x4, x5, op_push1
    li   x5, 0x01
    beq  x4, x5, op_add
    li   x5, 0x02
    beq  x4, x5, op_mul
    li   x5, 0x03
    beq  x4, x5, op_sub
    li   x5, 0x80
    beq  x4, x5, op_dup1
    li   x5, 0x90
    beq  x4, x5, op_swap1
    li   x5, 0x50
    beq  x4, x5, op_pop
    li   x5, 0x57
    beq  x4, x5, op_jumpi
    li   x5, 0x5b
    beq  x4, x5, step  # JUMPDEST is a no-op
    li   x5, 0x2000    # STOP/unknown: pop result if any
    beq  x3, x5, fin0
    sub  x3, x3, x7
    lw   x10, x3, 0
    halt
fin0:
    li   x10, 0
    halt
op_push1:
    li   x6, 0x1000
    add  x6, x6, x2
    lw   x5, x6, 0
    add  x2, x2, x7
    sw   x5, x3, 0
    add  x3, x3, x7
    j    step
op_add:
    sub  x3, x3, x7
    lw   x5, x3, 0
    sub  x3, x3, x7
    lw   x6, x3, 0
    add  x5, x5, x6
    sw   x5, x3, 0
    add  x3, x3, x7
    j    step
op_mul:
    sub  x3, x3, x7
    lw   x5, x3, 0
    sub  x3, x3, x7
    lw   x6, x3, 0
    mul  x5, x5, x6
    sw   x5, x3, 0
    add  x3, x3, x7
    j    step
op_sub:
    sub  x3, x3, x7
    lw   x5, x3, 0     # a = top
    sub  x3, x3, x7
    lw   x6, x3, 0     # b
    sub  x5, x5, x6    # EVM SUB pushes a - b
    sw   x5, x3, 0
    add  x3, x3, x7
    j    step
op_dup1:
    sub  x6, x3, x7
    lw   x5, x6, 0
    sw   x5, x3, 0
    add  x3, x3, x7
    j    step
op_swap1:
    sub  x6, x3, x7
    lw   x5, x6, 0
    sub  x8, x6, x7
    lw   x9, x8, 0
    sw   x5, x8, 0
    sw   x9, x6, 0
    j    step
op_pop:
    sub  x3, x3, x7
    j    step
op_jumpi:
    sub  x3, x3, x7
    lw   x5, x3, 0     # dest
    sub  x3, x3, x7
    lw   x6, x3, 0     # cond
    beq  x6, x0, step
    mv   x2, x5
    j    step
"""
