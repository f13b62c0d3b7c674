"""The port's LLVM toolchain (eigen_zkvm_tpu_torch/zkvm/llvm_backend.py: the
libLLVM-15 RISC-V backend through ctypes and the RV32 static linker) and
its three IR guests (zkvm/guests_llvm.py) against the JAX package's.

The port's copies of the committed ELFs (data/llvm_guests/*.elf.gz) hold
the JAX package's bytes; the port's `ir_to_elf` rebuilds each from its IR,
and its compiler and linker give the JAX package's object and image (both
skipped only where libLLVM-15 is missing, as tests/test_llvm_guests.py
does); the pc-relative linker case runs; each guest runs to its
`*_expected()` oracle on the port's executors; muldiv's chunk 0 gives the
JAX machine's constant and committed columns at 2^16 rows.  Every
comparison is exact.
"""
import json

import numpy as np
import pytest
import torch

from eigen_zkvm_tpu.zkvm import elf as j_elf
from eigen_zkvm_tpu.zkvm import guests_llvm as j_gl
from eigen_zkvm_tpu.zkvm import llvm_backend as j_lb
from eigen_zkvm_tpu.zkvm import rv32 as j_rv32
from eigen_zkvm_tpu.zkvm import rv32_native as j_native
from eigen_zkvm_tpu_torch.bench_chain import pil_to_json
from eigen_zkvm_tpu_torch.zkvm import elf, rv32, rv32_native
from eigen_zkvm_tpu_torch.zkvm import guests_llvm as gl
from eigen_zkvm_tpu_torch.zkvm import llvm_backend as lb
from eigen_zkvm_tpu_torch.zkvm.rv32_isa import execute

NAMES = sorted(gl.GUESTS)
needs_llvm = pytest.mark.skipif(not lb.available(),
                                reason="libLLVM unavailable")
PCREL_IR = """
@big = internal global [32 x i32] zeroinitializer, align 4
define i32 @main() {
entry:
  %p = getelementptr [32 x i32], [32 x i32]* @big, i32 0, i32 5
  store i32 777, i32* %p
  %v = load i32, i32* %p
  ret i32 %v
}
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_elf(blob):
    program, entry, image0, _rw, mem_base = elf.load_elf(
        blob, include_exec_in_image=False)
    mem = {mem_base + i: int(w) for i, w in enumerate(image0) if w}
    states, final = execute(program, entry, mem=mem, max_cycles=1 << 23)
    return program, states, final


@pytest.mark.parametrize("name", NAMES)
def test_fixture_copies_hold_the_jax_packages_bytes(name):
    """The port's gzip copy of each ELF, its IR and its oracle are the JAX
    package's."""
    assert gl.load_fixture(name) == j_gl.load_fixture(name)
    assert gl.GUESTS[name][0] == j_gl.GUESTS[name][0]
    assert gl.GUESTS[name][1]() == j_gl.GUESTS[name][1]()


@pytest.mark.parametrize("name", NAMES)
def test_committed_fixture_executes_correctly(name):
    """Each guest runs to its oracle on the port's Python executor and on
    its native executor."""
    blob = gl.load_fixture(name)
    _program, states, final = _run_elf(blob)
    want = gl.GUESTS[name][1]() & 0xFFFFFFFF
    assert final.halted and final.regs[10] == want, name
    program, entry, image0, ram_words, mem_base = elf.load_elf(
        blob, include_exec_in_image=False)
    nc = rv32_native.NativeChunker(program, entry, n_bits=16,
                                   ram_words=ram_words, image0=image0,
                                   mem_base=mem_base)
    assert nc.final.regs[10] == want
    assert nc.total_cycles == len(states) - 1


def test_fixtures_exercise_foreign_codegen_patterns():
    """Encodings cc.py never emits: auipc-relative data access beyond the
    _start stub, and muldiv's mulh/mulhu."""
    prog_crc, _, _ = _run_elf(gl.load_fixture("crc32"))
    assert len([1 for ins in prog_crc.values() if ins.op == "auipc"]) >= 2
    prog_md, _, _ = _run_elf(gl.load_fixture("muldiv"))
    ops = {ins.op for ins in prog_md.values()}
    assert "mulhu" in ops and "mulh" in ops, ops


@needs_llvm
@pytest.mark.parametrize("name", NAMES)
def test_fixtures_rebuild_byte_identical(name):
    """The port's ir_to_elf of each guest's IR is the committed ELF."""
    assert lb.ir_to_elf(gl.GUESTS[name][0]) == gl.load_fixture(name)


@needs_llvm
@pytest.mark.parametrize("name", NAMES)
def test_compile_and_link_match_the_jax_package(name):
    """compile_ir's object bytes (the guest's IR behind the _start stub)
    and link_rv32's image (ELF, entry, symbols) are the JAX package's."""
    assert lb.START_ASM == j_lb.START_ASM
    ir = lb.START_ASM + gl.GUESTS[name][0]
    obj = lb.compile_ir(ir)
    assert obj == j_lb.compile_ir(ir)
    a, b = lb.link_rv32(obj), j_lb.link_rv32(obj)
    assert (a.elf, a.entry, a.symbols) == (b.elf, b.entry, b.symbols)


@needs_llvm
def test_linker_handles_pcrel_pairs():
    """The PCREL_HI20/LO12 pairing (auipc + addi across a >4K text/data
    distance) on a fresh compile."""
    blob = lb.ir_to_elf(PCREL_IR)
    assert blob == j_lb.ir_to_elf(PCREL_IR)
    _prog, _st, final = _run_elf(blob)
    assert final.regs[10] == 777


def test_without_libllvm_the_backend_says_so(monkeypatch):
    """available() is False, not an error, when no libLLVM loads."""
    monkeypatch.setattr(lb, "_llvm", False)
    assert not lb.available()


def test_muldiv_chunk0_machine_matches_the_jax_package():
    """muldiv's chunk 0 at 2^16 rows (the 4,096-word image needs 39,936
    coprocessor rows): the machine's PIL, its constant columns and the
    chunk's committed columns equal the JAX machine's."""
    blob = gl.load_fixture("muldiv")
    program, entry, image0, ram_words, mem_base = elf.load_elf(
        blob, include_exec_in_image=False)
    assert ram_words == 4096
    nc = rv32_native.NativeChunker(program, entry, n_bits=16,
                                   ram_words=ram_words, image0=image0,
                                   mem_base=mem_base)
    j_program, j_entry, j_image0, _, _ = j_elf.load_elf(
        blob, include_exec_in_image=False)
    j_nc = j_native.NativeChunker(j_program, j_entry, n_bits=16,
                                  ram_words=ram_words, image0=j_image0,
                                  mem_base=mem_base)
    m = rv32.Rv32Machine(program, 16, ram_words=ram_words, mem_base=mem_base)
    jm = j_rv32.Rv32Machine(j_program, 16, ram_words=ram_words,
                            mem_base=mem_base)
    assert json.dumps(pil_to_json(m.pil)) == json.dumps(pil_to_json(jm.pil))
    assert np.array_equal(m.const_pols.buffer, jm.const_pols.buffer)
    states, image_in = nc.states_for(0)
    j_states, j_image_in = j_nc.states_for(0)
    assert np.array_equal(image_in, j_image_in)
    cm = m.trace(states, image_in=image_in)
    assert np.array_equal(cm.buffer,
                          jm.trace(j_states, image_in=j_image_in).buffer)
    assert (m.pil.nCommitments, m.pil.nConstants) == (375, 179)
