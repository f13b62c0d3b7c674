"""Linear-regression guest (the reference's second guest family,
zkvm/program/lr/src/lib.rs: simple_linear_regression over (x, y) pairs).

The reference guest runs f64 math under powdr; RV32IM has no FPU, so
this guest computes the same closed-form least-squares fit in Q16.16
fixed point with integer mul/div — strictly more than the reference's
build, which hardcodes a 2-point dataset and discards the result.

    slope     = N·Σxy − Σx·Σy  /  N·Σx² − (Σx)²      (scaled by 2^16)
    intercept = (Σy − slope·Σx) / N                   (Q16.16)

The dataset lives in a .data segment of an ELF32 container (word 0 = N,
then N little-endian (x, y) u32 pairs), the guest is real machine code
loaded through zkvm/elf.py, and the run proves with RAM-image
continuation digests.  Results land in a0 (slope) and a1 (intercept),
exposed as the x10_out / x11_out boundary publics.

Copy of eigen_zkvm_tpu/zkvm/guest_lr.py for the PyTorch port: `prove_lr`
proves on `device` (None: the current CUDA device, raising without one;
"cpu" is the explicit CPU path)."""
from __future__ import annotations

DATA_VADDR = 0x80

# register map: s0=&data, s1=N, s2=Σx, s3=Σy, s4=Σxy, s5=Σx²
LR_ASM = f"""
    li s0, {DATA_VADDR}
    lw s1, 0(s0)      # N
    addi s0, s0, 4
    li s2, 0
    li s3, 0
    li s4, 0
    li s5, 0
    mv t0, s1
acc:
    beq t0, zero, fit
    lw t1, 0(s0)      # x
    lw t2, 4(s0)      # y
    add s2, s2, t1
    add s3, s3, t2
    mul t3, t1, t2
    add s4, s4, t3
    mul t3, t1, t1
    add s5, s5, t3
    addi s0, s0, 8
    addi t0, t0, -1
    j acc
fit:
    mul t0, s1, s4    # N·Σxy
    mul t1, s2, s3    # Σx·Σy
    sub t0, t0, t1    # numerator
    mul t1, s1, s5    # N·Σx²
    mul t2, s2, s2    # (Σx)²
    sub t1, t1, t2    # denominator
    slli t0, t0, 16   # Q16.16 scale before the divide
    div a0, t0, t1    # slope (Q16.16)
    slli t3, s3, 16   # Σy<<16
    mul t4, a0, s2    # slope·Σx (already Q16.16)
    sub t3, t3, t4
    div a1, t3, s1    # intercept (Q16.16)
    ecall
"""


def lr_reference(pairs):
    """Host-side mirror of the GUEST's arithmetic, bit for bit: every
    mul/add wraps at 32 bits (`mul`/`add` keep the low word), `slli 16`
    truncates, and `div` is the RISC-V signed divide — truncating toward
    zero, -1 on divide-by-zero, dividend on -2^31 / -1 overflow."""
    M32 = 0xFFFFFFFF

    def s32(v):
        v &= M32
        return v - (1 << 32) if v & 0x80000000 else v

    def rv_div(a, b):  # signed 32-bit operands as u32, result u32
        sa, sb = s32(a), s32(b)
        if sb == 0:
            return M32
        if sa == -(1 << 31) and sb == -1:
            return a & M32
        q = abs(sa) // abs(sb)
        if (sa < 0) != (sb < 0):
            q = -q
        return q & M32

    n = len(pairs) & M32
    sx = sy = sxy = sxx = 0
    for x, y in pairs:
        sx = (sx + x) & M32
        sy = (sy + y) & M32
        sxy = (sxy + x * y) & M32
        sxx = (sxx + x * x) & M32
    num = (n * sxy - sx * sy) & M32
    den = (n * sxx - sx * sx) & M32
    slope = rv_div((num << 16) & M32, den)
    t3 = ((sy << 16) - slope * sx) & M32
    intercept = rv_div(t3, n)
    return slope, intercept


def lr_elf(pairs) -> bytes:
    """Pack the dataset into a .data segment and emit the guest ELF."""
    from .elf import make_elf
    from .rv32_isa import assemble

    data = len(pairs).to_bytes(4, "little")
    for x, y in pairs:
        data += int(x).to_bytes(4, "little") + int(y).to_bytes(4, "little")
    return make_elf(assemble(LR_ASM), entry=0, data_bytes=data,
                    data_vaddr=DATA_VADDR)


def prove_lr(pairs, n_bits: int = 11, n_queries: int = 2, device=None):
    """Prove the fit on `device`; returns (slope, intercept, proofs,
    publics_list)."""
    from .elf import elf_execute_and_prove

    proofs, pubs, _m, _s, _ss = elf_execute_and_prove(
        lr_elf(pairs), n_bits=n_bits, n_queries=n_queries, device=device)
    return pubs[-1]["x10_out"], pubs[-1]["x11_out"], proofs, pubs
