"""The port's guest programs (eigen_zkvm_tpu_torch/zkvm/{guests,guest_lr}.py)
against the JAX package's: the MiniRV programs assemble to the same
instructions and run to the same states on both executors and to their
Python results; the linear-regression guest's ELF, its Q16.16 oracle and
its run on the port's RV32 executor agree with the JAX package's; its
prove entry point raises without a card unless the CPU is asked for.
Every comparison is exact.
"""
import dataclasses
import math

import pytest
import torch

from eigen_zkvm_tpu.zkvm import guest_lr as j_guest_lr
from eigen_zkvm_tpu.zkvm import guests as j_guests
from eigen_zkvm_tpu.zkvm import isa as j_isa
from eigen_zkvm_tpu_torch.zkvm import elf, guest_lr, guests, isa, rv32_isa

M32 = (1 << 32) - 1


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fib(n):
    a, b = 0, 1
    for _ in range(n):
        a, b = b, a + b
    return b & M32


def _lr_sums(pairs):
    n = len(pairs)
    sx, sy = sum(x for x, _ in pairs), sum(y for _, y in pairs)
    sxy = sum(x * y for x, y in pairs)
    sxx = sum(x * x for x, _ in pairs)
    return (n * sxy - sx * sy) & M32, (n * sxx - sx * sx) & M32


LR_PAIRS = [(3, 7), (1, 2), (4, 9), (10, 30), (6, 11)]
EVM_CODE = [0x60, 2, 0x60, 4, 0x60, 3, 0x01, 0x60, 5, 0x02, 0x03, 0x00]
# name: (tape, {register: its value at the halt})
MINIRV = {
    "FIBONACCI": ([20], {3: _fib(20)}),
    "LINEAR_REGRESSION": ([len(LR_PAIRS)] + [v for p in LR_PAIRS for v in p],
                          dict(zip((5, 6), _lr_sums(LR_PAIRS)))),
    "GCD": ([252, 105], {2: math.gcd(252, 105)}),
    "POW": ([7, 13], {3: pow(7, 13, 1 << 32)}),
    "MEMSUM": ([4, 10, 20, 30, 40], {7: 100}),
    "EVM": ([len(EVM_CODE)] + EVM_CODE, {10: 33}),   # 5 * (3 + 4) - 2
}


def _instrs(prog):
    return [dataclasses.astuple(i) for i in prog]


@pytest.mark.parametrize("name", sorted(MINIRV))
def test_minirv_programs_match_the_jax_package(name):
    """Each MiniRV program of guests.py: the port's text is the JAX
    package's, assembles to the same instructions, and runs on both
    executors through the same states to its Python result."""
    src = getattr(guests, name)
    assert src == getattr(j_guests, name)
    prog, j_prog = isa.assemble(src), j_isa.assemble(src)
    assert _instrs(prog) == _instrs(j_prog)
    tape, want = MINIRV[name]
    states, final = isa.execute(prog, list(tape))
    j_states, j_final = j_isa.execute(j_prog, list(tape))
    assert final.halted and len(states) == len(j_states)
    assert [dataclasses.astuple(s) for s in states] == \
        [dataclasses.astuple(s) for s in j_states]
    assert dataclasses.astuple(final) == dataclasses.astuple(j_final)
    for reg, value in want.items():
        assert final.regs[reg] == value, (name, reg)


LR_SETS = {
    "exact": [(1, 3), (2, 5), (3, 7), (4, 9), (5, 11)],   # y = 2x + 1
    "noisy": [(0, 1), (2, 2), (3, 7), (9, 4), (12, 20), (15, 16)],
    "steep": [(1, 1000), (2, 2100), (3, 2900), (4, 4200)],
}


@pytest.mark.parametrize("name", sorted(LR_SETS))
def test_lr_guest_matches_the_jax_package_and_its_oracle(name):
    """lr_reference, the ELF's bytes and the guest's (a0, a1) on the
    port's RV32 executor: equal to the JAX package's and to the oracle
    (the exact fit gives slope 2 and intercept 1 in Q16.16)."""
    pairs = LR_SETS[name]
    assert guest_lr.LR_ASM == j_guest_lr.LR_ASM
    want = guest_lr.lr_reference(pairs)
    assert want == j_guest_lr.lr_reference(pairs)
    blob = guest_lr.lr_elf(pairs)
    assert blob == j_guest_lr.lr_elf(pairs)
    program, entry, image0, ram_words, mem_base = elf.load_elf(blob)
    mem = {mem_base + i: int(w) for i, w in enumerate(image0) if w}
    _states, final = rv32_isa.execute(program, entry, mem=mem)
    assert final.halted
    assert (final.regs[10], final.regs[11]) == want
    if name == "exact":
        assert want == (2 << 16, 1 << 16)


def test_prove_lr_raises_without_a_card(monkeypatch):
    """device=None is the current CUDA device: without one, prove_lr raises
    before it proves anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        guest_lr.prove_lr(LR_SETS["exact"], n_bits=10)
