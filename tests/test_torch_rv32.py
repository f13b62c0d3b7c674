"""The port's RV32IM zkVM front end (eigen_zkvm_tpu_torch/zkvm/) against the
JAX package's: the decoder, assembler and Python executor, the ELF loader,
the native executor and its chunker, the RAM-image digest, the machine's
PIL, constants and trace, and the proof JSON of every chunk of a guest
that spans four chunks, byte for byte, with the port proving on the CPU
(Engine("cpu"): the kernels' plain versions, the plookup halves by the
tensor version a card runs) and the JAX package on its host engine.

The ecrecover guest is the committed fixture
eigen_zkvm_tpu_torch/data/guests/ecrecover.elf.gz (gzip), which the port's C
compiler (zkvm/cc.py) and the JAX package's both rebuild byte for byte
(where pycparser is installed).  The last
tests prove its chunk 0 on the card (marked cuda) and recompute, on the
JAX package's host engine, the digests chip_smoke.py holds the card's
proofs to (marked slow: about six minutes on one core):

    python -m pytest --noconftest -p no:cacheprovider -m cuda -s \\
        tests/test_torch_rv32.py
    JAX_PLATFORMS=cpu python -m pytest -p no:cacheprovider -m slow -s \\
        tests/test_torch_rv32.py
"""
import dataclasses
import hashlib
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from eigen_zkvm_tpu.recursion.circuit import \
    _poseidon_tables as j_poseidon_tables
from eigen_zkvm_tpu.stark import stark_gen as host_gen
from eigen_zkvm_tpu.stark import stark_setup as host_setup
from eigen_zkvm_tpu.stark.serializer import stark_proof_to_json as host_json
from eigen_zkvm_tpu.zkvm import continuations as j_cont
from eigen_zkvm_tpu.zkvm import elf as j_elf
from eigen_zkvm_tpu.zkvm import rv32 as j_rv32
from eigen_zkvm_tpu.zkvm import rv32_isa as j_isa
from eigen_zkvm_tpu.zkvm import rv32_lib as j_rv32_lib
from eigen_zkvm_tpu.zkvm import rv32_native as j_native
from eigen_zkvm_tpu_torch import bench_zkvm
from eigen_zkvm_tpu_torch.bench_chain import pil_to_json
from eigen_zkvm_tpu_torch.stark import stark_gen as port_gen
from eigen_zkvm_tpu_torch.stark.engine import Engine
from eigen_zkvm_tpu_torch.stark.serializer import stark_proof_to_json
from eigen_zkvm_tpu_torch.zkvm import continuations, elf, rv32, rv32_isa
from eigen_zkvm_tpu_torch.zkvm import rv32_lib, rv32_native

from test_rv32 import MIX

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LLVM_DIR = os.path.join(ROOT, "eigen_zkvm_tpu", "data", "llvm_guests")
# tests/test_rv32.py::test_rv32_continuations_multichunk's guest: byte
# stores (2-row micro-cycles) over a 32-word image, 3 or more 2^10-row
# chunks
MULTICHUNK = """
    li a0, 600        # iterations
    li a1, 0          # i
    li a2, 96         # byte area size (24 words)
loop:
    beq a1, a0, sum
    remu t0, a1, a2   # t0 = i mod 96
    sb a1, 0(t0)      # overwrite an image byte  (2-row micro-op)
    addi a1, a1, 1
    j loop
sum:
    li t1, 0          # acc
    li t2, 0          # addr
rd:
    beq t2, a2, done
    lbu t3, 0(t2)
    add t1, t1, t3
    addi t2, t2, 1
    j rd
done:
    ecall
"""


def _state(s):
    return (s.pc, tuple(s.regs), s.halted, s.mem_op)


def _states(states):
    return [_state(s) for s in states]


def _program(prog):
    return {pc: dataclasses.astuple(ins) for pc, ins in prog.items()}


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain versions run many small tensor ops: one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _host_engine(monkeypatch):
    """The JAX package's host engine: it never probes for a TPU."""
    monkeypatch.setenv("EIGEN_ZKVM_ENGINE", "host")


@pytest.fixture
def tensor_h1h2(monkeypatch):
    """Stage 2 on CPU tensors runs the tensor version, as on a card."""
    monkeypatch.setattr(port_gen, "h1h2", port_gen.calculate_h1h2_tensor)


@pytest.fixture(scope="module")
def guest_bytes():
    return bench_zkvm.read_guest()


# ---- decoder, assembler, executor, ELF loader


def _load_llvm(mod, name):
    with open(os.path.join(LLVM_DIR, f"{name}.elf"), "rb") as f:
        program, entry, image0, ram_words, mem_base = mod.load_elf(
            f.read(), include_exec_in_image=False)
    mem = {mem_base + i: int(w) for i, w in enumerate(image0) if w}
    return program, entry, mem, (ram_words, mem_base, image0)


@pytest.mark.parametrize("name", ["mix", "crc32", "muldiv", "sort"])
def test_isa_and_executor_match_the_jax_package(name):
    """MIX (tests/test_rv32.py) and the three committed LLVM ELFs: the same
    words, instructions, loaded images and execution states."""
    if name == "mix":
        words = rv32_isa.assemble(MIX)
        assert words == j_isa.assemble(MIX)
        port = {4 * i: rv32_isa.decode(w, 4 * i) for i, w in enumerate(words)}
        jax_prog = {4 * i: j_isa.decode(w, 4 * i) for i, w in enumerate(words)}
        entry = j_entry = 0
        mem = j_mem = {}
    else:
        port, entry, mem, extra = _load_llvm(elf, name)
        jax_prog, j_entry, j_mem, j_extra = _load_llvm(j_elf, name)
        assert extra[:2] == j_extra[:2]
        assert np.array_equal(extra[2], j_extra[2])
        assert (entry, mem) == (j_entry, j_mem)
    assert _program(port) == _program(jax_prog)
    states, final = rv32_isa.execute(port, entry, mem=dict(mem),
                                     max_cycles=1 << 23)
    j_states, j_final = j_isa.execute(jax_prog, j_entry, mem=dict(j_mem),
                                      max_cycles=1 << 23)
    assert final.halted and len(states) > 50
    assert _states(states) == _states(j_states)
    assert _state(final) == _state(j_final)


def test_elf_round_trip_and_c_loader_match_the_jax_package(guest_bytes):
    words = rv32_isa.assemble(MIX)
    data = bytes(range(64))
    made = elf.make_elf(words, entry=8, text_vaddr=0, data_bytes=data,
                        data_vaddr=0x2000)
    assert made == j_elf.make_elf(words, entry=8, text_vaddr=0,
                                  data_bytes=data, data_vaddr=0x2000)
    for src, exec_in_image in ((made, True), (made, False),
                               (guest_bytes, False)):
        a = elf.load_elf(src, include_exec_in_image=exec_in_image)
        b = j_elf.load_elf(src, include_exec_in_image=exec_in_image)
        assert _program(a[0]) == _program(b[0])
        assert a[1] == b[1] and a[3:] == b[3:]
        assert np.array_equal(a[2], b[2])
    c = elf.load_c_elf(guest_bytes)
    assert c[3:] == (2048, 32)
    assert len(c[0]) == 6735
    with pytest.raises(elf.ElfError):
        elf.load_elf(b"\x7fELF" + bytes(60))


# ---- native executor


def test_native_chunker_matches_the_jax_package_on_ecrecover(guest_bytes):
    program, entry, image0, ram_words, mem_base = elf.load_c_elf(guest_bytes)
    port = rv32_native.NativeChunker(program, entry, n_bits=16,
                                     ram_words=ram_words, image0=image0,
                                     mem_base=mem_base)
    j_program, *rest = j_elf.load_elf(guest_bytes,
                                      include_exec_in_image=False)
    ref = j_native.NativeChunker(j_program, rest[0], n_bits=16,
                                 ram_words=rest[2], image0=rest[1],
                                 mem_base=rest[3])
    assert len(port.chunks) == len(ref.chunks) == bench_zkvm.GUEST_CHUNKS
    assert port.total_cycles == ref.total_cycles == bench_zkvm.GUEST_CYCLES
    for a, b in zip(port.chunks, ref.chunks):
        assert (a.pc_in, a.n_cycles, a.n_rows, a.halted) == \
            (b.pc_in, b.n_cycles, b.n_rows, b.halted)
        assert np.array_equal(a.regs_in, b.regs_in)
    assert np.array_equal(port.final_image, ref.final_image)
    assert _state(port.final) == _state(ref.final)
    for k in (0, 1, 238):
        states, image_in = port.states_for(k)
        j_states, j_image_in = ref.states_for(k)
        assert np.array_equal(image_in, j_image_in)
        assert _states(states) == _states(j_states), k


@pytest.mark.parametrize("name", ["mix", "multichunk"])
def test_native_chunker_matches_the_python_executor(name):
    """The port's NativeChunker against the port's own rv32_generate_chunks
    (the Python executor): every chunk's states and incoming image."""
    if name == "mix":
        nbits, ram_words, src = 11, None, MIX
    else:
        nbits, ram_words, src = 10, 32, MULTICHUNK
    program = rv32_lib.program_from_asm(src)
    chunks, final = rv32_lib.rv32_generate_chunks(program, 0, nbits,
                                                  ram_words=ram_words)
    nc = rv32_native.NativeChunker(program, 0, n_bits=nbits,
                                   ram_words=ram_words)
    assert len(nc.chunks) == len(chunks) >= (1 if name == "mix" else 3)
    for k, (states, image_in) in enumerate(chunks):
        got, got_image = nc.states_for(k)
        assert _states(got) == _states(states), k
        if ram_words is not None:
            assert np.array_equal(got_image, image_in)
    assert _state(nc.final) == _state(final)


def test_native_executor_raises_when_it_cannot_be_built(monkeypatch,
                                                        tmp_path):
    """No silent fallback: without g++ on PATH, or when g++ fails, building
    the executor (and so NativeChunker) raises with the reason."""
    program = rv32_lib.program_from_asm(MIX)
    monkeypatch.setattr(rv32_native, "_lib", None)
    monkeypatch.setattr(rv32_native, "BUILD_DIR", str(tmp_path / "build"))
    empty = tmp_path / "bin"
    empty.mkdir()
    with monkeypatch.context() as m:
        m.setenv("PATH", str(empty))
        with pytest.raises(rv32_native.NativeBuildError, match="g\\+\\+ not"):
            rv32_native.NativeChunker(program, 0, n_bits=11)
    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(rv32_native, "SRC", str(broken))
    with pytest.raises(rv32_native.NativeBuildError, match="error"):
        rv32_native.NativeChunker(program, 0, n_bits=11)
    assert rv32_native._lib is None
    assert not list((tmp_path / "build").glob("*.so"))


def test_op_ids_match_the_cpp_enum():
    with open(rv32_native.SRC) as f:
        src = f.read()
    body = src.split("enum Op : uint8_t {")[1].split("}")[0]
    names = [t.strip().split("=")[0].strip() for t in body.split(",")
             if t.strip()]
    assert names == [f"OP_{op.upper()}" for op, _ in
                     sorted(rv32_native.OP_IDS.items(), key=lambda x: x[1])]
    assert rv32_native.OP_IDS == j_native.OP_IDS


# ---- continuations, machine


def test_ram_digest_matches_the_jax_package(guest_bytes):
    rng = np.random.default_rng(9)
    images = [rng.integers(0, 2**32, size=n, dtype=np.uint64)
              for n in (8, 32, 2048)]
    images.append(elf.load_c_elf(guest_bytes)[2])
    images.append(np.zeros(64, dtype=np.uint64))
    for img in images:
        assert continuations.ram_digest(img) == j_cont.ram_digest(img)
    assert continuations._poseidon_tables() == j_poseidon_tables()


def _machines(name, guest_bytes):
    """(port machine, port states, port image, JAX machine, JAX states, JAX
    image) for a case's chunk 0."""
    if name == "mix":
        words = rv32_isa.assemble(MIX)
        prog = {4 * i: rv32_isa.decode(w, 4 * i) for i, w in enumerate(words)}
        j_prog = {4 * i: j_isa.decode(w, 4 * i) for i, w in enumerate(words)}
        states = rv32_isa.execute(prog, 0)[0]
        j_states = j_isa.execute(j_prog, 0)[0]
        return (rv32.Rv32Machine(prog, 11), states, None,
                j_rv32.Rv32Machine(j_prog, 11), j_states, None)
    program, entry, image0, ram_words, mem_base = elf.load_c_elf(guest_bytes)
    nc = rv32_native.NativeChunker(program, entry, n_bits=16,
                                   ram_words=ram_words, image0=image0,
                                   mem_base=mem_base)
    j_program, j_entry, j_image0, _, _ = j_elf.load_elf(
        guest_bytes, include_exec_in_image=False)
    j_nc = j_native.NativeChunker(j_program, j_entry, n_bits=16,
                                  ram_words=ram_words, image0=j_image0,
                                  mem_base=mem_base)
    return (rv32.Rv32Machine(program, 16, ram_words=ram_words,
                             mem_base=mem_base), *nc.states_for(0),
            j_rv32.Rv32Machine(j_program, 16, ram_words=ram_words,
                               mem_base=mem_base), *j_nc.states_for(0))


@pytest.mark.parametrize("name", ["mix", "ecrecover"])
def test_rv32_machine_pil_constants_and_trace_match_the_jax_package(
        name, guest_bytes):
    """MIX at 2^11, and ecrecover's chunk 0 at 2^16 (375 committed and 179
    constant columns): PIL JSON, constant and committed buffers equal."""
    m, states, image, jm, j_states, j_image = _machines(name, guest_bytes)
    assert json.dumps(pil_to_json(m.pil)) == json.dumps(pil_to_json(jm.pil))
    assert np.array_equal(m.const_pols.buffer, jm.const_pols.buffer)
    cm = m.trace(states, image_in=image)
    j_cm = jm.trace(j_states, image_in=j_image)
    assert np.array_equal(cm.buffer, j_cm.buffer)
    if name == "ecrecover":
        assert (m.pil.nCommitments, m.pil.nConstants) == (375, 179)
        assert (len(m.pil.plookupIdentities),
                len(m.pil.permutationIdentities)) == (99, 3)


# ---- proofs


def test_rv32_chunks_with_tensor_h1h2_are_byte_identical_and_chain(
        tensor_h1h2):
    """tests/test_rv32.py's multi-chunk guest (2^10 rows, a 32-word image)
    through rv32_execute_and_prove on the CPU, its 99 plookups' halves by
    the tensor version: every proof equals the host engine's, the port's
    verifier accepts it (the entry point self-verifies), the chain holds
    and breaks under a forged digest."""
    proofs, pubs, m, setup, ss = rv32_lib.rv32_execute_and_prove(
        MULTICHUNK, n_bits=10, ram_words=32, n_queries=2, device="cpu")
    j_proofs, j_pubs, *_ = j_rv32_lib.rv32_execute_and_prove(
        MULTICHUNK, n_bits=10, ram_words=32, n_queries=2)
    assert len(proofs) == len(j_proofs) >= 3
    assert pubs == j_pubs
    for p, q in zip(proofs, j_proofs):
        assert stark_proof_to_json(p) == host_json(q)
    assert rv32_lib.check_chain_publics(pubs)
    membytes = bytearray(96)
    for i in range(600):
        membytes[i % 96] = i & 0xFF
    assert pubs[-1]["x6_out"] == sum(membytes)
    d0 = continuations.ram_digest(np.zeros(32, dtype=np.uint64))
    assert [pubs[0][f"mem_in{j}"] for j in range(4)] == d0
    for k in range(len(pubs) - 1):
        forged = dict(pubs[k + 1])
        forged["mem_in1"] ^= 1
        assert not rv32_lib.check_chain_publics([pubs[k], forged])


def test_fixture_is_what_the_jax_compiler_builds(guest_bytes):
    """data/guests/ecrecover.elf.gz holds cc.c_to_elf of guest_secp256k1's source
    for scripts/zkvm_e2e.py's signature."""
    pytest.importorskip("pycparser")
    from eigen_zkvm_tpu.zkvm import guest_secp256k1 as g
    from eigen_zkvm_tpu.zkvm.cc import c_to_elf

    priv = 0xC0FFEE254729296A45A3885639AC7E10F9D54979787FA3A62E9E0C2F1B1B1B1B
    e = int.from_bytes(g.keccak256_ref(b"round-4 ecrecover vector"), "big")
    k = 0xA1B2C3D4E5F60718293A4B5C6D7E8F901122334455667788991011121314D00D
    v, r, s = g.sign(e, priv, k)
    assert c_to_elf(g.build_guest_source(e, v, r, s)) == guest_bytes


def test_fixture_is_what_the_port_compiler_builds(guest_bytes):
    """The same ELF from the port's own toolchain: zkvm/cc.c_to_elf of the
    port's guest_secp256k1 source for the same signature."""
    pytest.importorskip("pycparser")
    from eigen_zkvm_tpu_torch.zkvm import guest_secp256k1 as g
    from eigen_zkvm_tpu_torch.zkvm.cc import c_to_elf

    priv = 0xC0FFEE254729296A45A3885639AC7E10F9D54979787FA3A62E9E0C2F1B1B1B1B
    e = int.from_bytes(g.keccak256_ref(b"round-4 ecrecover vector"), "big")
    k = 0xA1B2C3D4E5F60718293A4B5C6D7E8F901122334455667788991011121314D00D
    v, r, s = g.sign(e, priv, k)
    assert c_to_elf(g.build_guest_source(e, v, r, s)) == guest_bytes


@pytest.mark.cuda
def test_ecrecover_chunk0_on_the_card_matches_the_pinned_digest():
    """Chunk 0 of the ecrecover guest at 2^16 rows, proved on the card
    through bench_zkvm (rv32_prove_only, self-verifying): its zkin JSON's
    sha256 is chip_smoke.ZKVM_SHA256[0], its digests hold, the NTT and
    Poseidon kernels launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    smoke = _smoke()
    engine = Engine()
    guest = bench_zkvm.Guest()
    machine, setup, ss, _ = bench_zkvm.setup_machine(
        guest, bench_zkvm.QUERIES, engine)
    r = bench_zkvm.prove_chunk(guest, machine, setup, ss, 0, engine)
    assert r["digests_hold"]
    assert r["launches"]["ntt"] > 0 and r["launches"]["poseidon_gl"] > 0
    assert r["zkin_sha256"] == smoke.ZKVM_SHA256[0], r["zkin_sha256"]


@pytest.mark.slow
def test_host_engine_gives_the_pinned_zkvm_digests(guest_bytes):
    """The digests chip_smoke.py holds ecrecover's chunks 0 and 1 to: the
    JAX package's host-engine proofs (default_struct(16, 4)), printed."""
    from eigen_zkvm_tpu.zkvm.lib import default_struct

    smoke = _smoke()
    program, entry, image0, ram_words, mem_base = j_elf.load_elf(
        guest_bytes, include_exec_in_image=False)
    nc = j_native.NativeChunker(program, entry, n_bits=16,
                                ram_words=ram_words, image0=image0,
                                mem_base=mem_base)
    m = j_rv32.Rv32Machine(program, 16, ram_words=ram_words,
                           mem_base=mem_base)
    ss = default_struct(16, bench_zkvm.QUERIES)
    setup = host_setup.StarkSetup(m.const_pols, m.pil, ss)
    for k in (0, 1):
        states, image_in = nc.states_for(k)
        proof = host_gen.stark_gen(m.trace(states, image_in=image_in),
                                   m.const_pols, setup.const_tree,
                                   setup.starkinfo, setup.program, ss)
        digest = hashlib.sha256(host_json(proof).encode()).hexdigest()
        print(f"chunk {k}: {digest}")
        assert digest == smoke.ZKVM_SHA256[k]
