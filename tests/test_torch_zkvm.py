"""The port's zkVM entry points and stage 2's plookup halves on the CPU,
against the JAX package.

`calculate_h1h2_tensor` (stark/stark_gen.py: the plookup's h1/h2 as tensor
code where the columns live, which a prove on the card runs) must give
the bits of the plain `calculate_h1h2` on random rows with repeated t rows,
and raise as it does on a missing row; the plookup example's proof, proved
with it in place of the plain version, stays byte-identical to the JAX
package's host prove (as do the RV32 chunk chain's proofs in
tests/test_torch_rv32.py).  RV32's MIX (tests/test_rv32.py) proves at 2^11
through rv32_prove_only with the host engine's bytes.  The MiniRV
machine's MEMWALK chain (tests/test_zkvm_continuations.py) proves through
`zkvm_execute_and_prove(device="cpu")` with the JAX package's PIL,
constants, traces and proof bytes.  The entry points raise without a card
unless the CPU is asked for.
"""
import json

import numpy as np
import pytest
import torch

from eigen_zkvm_tpu.examples import plookup as j_plookup
from eigen_zkvm_tpu.stark import stark_gen as host_gen
from eigen_zkvm_tpu.stark import stark_setup as host_setup
from eigen_zkvm_tpu.stark.serializer import stark_proof_to_json as host_json
from eigen_zkvm_tpu.stark.types import StarkStruct as HostStruct
from eigen_zkvm_tpu.stark.types import Step as HostStep
from eigen_zkvm_tpu.zkvm import lib as j_lib
from eigen_zkvm_tpu.zkvm import machine as j_machine
from eigen_zkvm_tpu.zkvm import rv32 as j_rv32
from eigen_zkvm_tpu.zkvm import rv32_isa as j_isa
from eigen_zkvm_tpu_torch.bench_chain import pil_to_json
from eigen_zkvm_tpu_torch.examples import plookup
from eigen_zkvm_tpu_torch.ops import gl
from eigen_zkvm_tpu_torch.stark import stark_gen as port_gen
from eigen_zkvm_tpu_torch.stark.engine import Engine
from eigen_zkvm_tpu_torch.stark.serializer import stark_proof_to_json
from eigen_zkvm_tpu_torch.stark.stark_setup import StarkSetup
from eigen_zkvm_tpu_torch.stark.stark_verify import stark_verify
from eigen_zkvm_tpu_torch.stark.types import StarkStruct, Step
from eigen_zkvm_tpu_torch.utils.profiler import Prof
from eigen_zkvm_tpu_torch.zkvm import elf, lib, machine, rv32, rv32_isa
from eigen_zkvm_tpu_torch.zkvm import rv32_lib

from test_rv32 import MIX
from test_torch_rv32 import _host_engine, _one_thread, tensor_h1h2  # noqa: F401
from test_zkvm_continuations import MEMWALK, NB, RAM

MEMWALK_TAPE = [450, 48]


# ---- stage 2's plookup halves


def _rows(rng, n, pool, dim):
    t = pool[rng.integers(0, len(pool), n)]
    if dim == 1:
        t[:, 1:] = 0
    return t


@pytest.mark.parametrize("seed", range(6))
def test_tensor_h1h2_equals_the_plain_version(seed):
    """Random t with repeated rows (f's keys are the LAST index of their
    row in t), f drawn from t, one and three coordinates."""
    rng = np.random.default_rng(seed)
    for n, n_pool, dim in ((1, 1, 1), (7, 3, 3), (64, 5, 1), (256, 200, 3),
                           (1 << 12, 40, 1)):
        pool = rng.integers(0, 2**64, size=(n_pool, 3), dtype=np.uint64)
        pool[0] = gl.P_INT - 1
        t = _rows(rng, n, pool, dim)
        f = t[rng.integers(0, n, n)]
        want = port_gen.calculate_h1h2(f, t)
        got = port_gen.calculate_h1h2_tensor(gl.from_u64(f), gl.from_u64(t))
        for w, g in zip(want, got):
            assert np.array_equal(w, gl.to_u64(g)), (seed, n, dim)


def test_tensor_h1h2_raises_on_a_missing_row_as_the_plain_version():
    rng = np.random.default_rng(3)
    t = rng.integers(0, 2**64, size=(32, 3), dtype=np.uint64)
    f = t[rng.integers(0, 32, 32)]
    f[5] = (1, 2, 3)
    f[9] = (4, 5, 6)
    with pytest.raises(ValueError) as want:
        port_gen.calculate_h1h2(f, t)
    with pytest.raises(ValueError) as got:
        port_gen.calculate_h1h2_tensor(gl.from_u64(f), gl.from_u64(t))
    assert str(got.value) == str(want.value) == \
        "Number not included: (1, 2, 3)"


def test_plookup_proof_with_tensor_h1h2_is_byte_identical(tensor_h1h2):
    ss = StarkStruct(nBits=5, nBitsExt=6, nQueries=3,
                     verificationHashType="GL", steps=[Step(6), Step(3)])
    j_ss = HostStruct(nBits=5, nBitsExt=6, nQueries=3,
                      verificationHashType="GL",
                      steps=[HostStep(6), HostStep(3)])
    pil, cp, mk = plookup.build(5)
    engine = Engine("cpu")
    setup = StarkSetup(cp, pil, ss, engine)
    proof = port_gen.stark_gen(mk(), cp, setup.const_tree, setup.starkinfo,
                               setup.program, ss, engine=engine)
    assert stark_verify(proof, setup.const_root, setup.starkinfo, ss,
                        setup.program)
    j_pil, j_cp, j_mk = j_plookup.build(5)
    js = host_setup.StarkSetup(j_cp, j_pil, j_ss)
    ref = host_gen.stark_gen(j_mk(), j_cp, js.const_tree, js.starkinfo,
                             js.program, j_ss)
    assert stark_proof_to_json(proof) == host_json(ref)


# ---- RV32: MIX at 2^11 with tests/test_rv32.py's StarkStruct


def test_mix_proof_is_byte_identical_to_the_host_engine():
    """rv32_prove_only on the CPU (trace, prove with the plain h1/h2, the
    port's verifier) against the JAX package's host prove of the same
    chunk."""
    words = rv32_isa.assemble(MIX)
    prog = {4 * i: rv32_isa.decode(w, 4 * i) for i, w in enumerate(words)}
    j_prog = {4 * i: j_isa.decode(w, 4 * i) for i, w in enumerate(words)}
    m, jm = rv32.Rv32Machine(prog, 11), j_rv32.Rv32Machine(j_prog, 11)
    ss = StarkStruct(nBits=11, nBitsExt=12, nQueries=2,
                     verificationHashType="GL", steps=[Step(12), Step(6)])
    j_ss = HostStruct(nBits=11, nBitsExt=12, nQueries=2,
                      verificationHashType="GL",
                      steps=[HostStep(12), HostStep(6)])
    setup = StarkSetup(m.const_pols, m.pil, ss, Engine("cpu"))
    states = rv32_isa.execute(prog, 0)[0]
    prof = Prof("mix", torch.device("cpu"), on=True)
    proof, pubs = rv32_lib.rv32_prove_only(m, setup, ss, states,
                                           device="cpu", prof=prof)
    stages = [t for t, _ in prof.stages]
    assert stages[0] == "trace" and stages[-1] == "verify"
    assert pubs["x21_out"] == states[-1].regs[21]
    assert pubs["x9_out"] == states[-1].regs[9]
    js = host_setup.StarkSetup(jm.const_pols, jm.pil, j_ss)
    ref = host_gen.stark_gen(jm.trace(j_isa.execute(j_prog, 0)[0]),
                             jm.const_pols, js.const_tree, js.starkinfo,
                             js.program, j_ss)
    assert setup.const_root.tolist() == [int(x) for x in js.const_root]
    assert stark_proof_to_json(proof) == host_json(ref)


# ---- MiniRV: the MEMWALK chain


def test_minirv_machine_pil_constants_and_traces_match_the_jax_package():
    program, chunks, final = lib.zkvm_generate_chunks(
        MEMWALK, MEMWALK_TAPE, n_bits=NB, ram_words=RAM)
    j_program, j_chunks, j_final = j_lib.zkvm_generate_chunks(
        MEMWALK, MEMWALK_TAPE, n_bits=NB, ram_words=RAM)
    assert len(chunks) == len(j_chunks) >= 3
    m = machine.MiniRVMachine(program, NB, ram_words=RAM)
    jm = j_machine.MiniRVMachine(j_program, NB, ram_words=RAM)
    m.set_tape(MEMWALK_TAPE)
    jm.set_tape(MEMWALK_TAPE)
    assert json.dumps(pil_to_json(m.pil)) == json.dumps(pil_to_json(jm.pil))
    assert np.array_equal(m.const_pols.buffer, jm.const_pols.buffer)
    for (states, image), (j_states, j_image) in zip(chunks, j_chunks):
        assert np.array_equal(image, j_image)
        cm = m.trace(states, MEMWALK_TAPE, image_in=image)
        j_cm = jm.trace(j_states, MEMWALK_TAPE, image_in=j_image)
        assert np.array_equal(cm.buffer, j_cm.buffer)


def test_minirv_memwalk_chain_is_byte_identical_to_the_host_engine():
    proofs, pubs, m, setup, ss = lib.zkvm_execute_and_prove(
        MEMWALK, MEMWALK_TAPE, n_bits=NB, n_queries=2, ram_words=RAM,
        device="cpu")
    j_proofs, j_pubs, *_ = j_lib.zkvm_execute_and_prove(
        MEMWALK, MEMWALK_TAPE, n_bits=NB, n_queries=2, ram_words=RAM)
    assert len(proofs) == len(j_proofs) >= 3
    assert pubs == j_pubs
    for p, q in zip(proofs, j_proofs):
        assert stark_proof_to_json(p) == host_json(q)
    assert lib.check_chunk_chain(pubs, continuations=True)
    forged = dict(pubs[1])
    forged["mem_in2"] ^= 1
    assert not lib.check_chunk_chain([pubs[0], forged], continuations=True)
    img = np.zeros(RAM, dtype=np.uint64)
    for i in range(1, MEMWALK_TAPE[0] + 1):
        img[(i - 1) % 48] = i
    assert pubs[-1]["x5_out"] == int(img[:48].sum())


# ---- the entry points' device


def test_entry_points_raise_without_a_card(monkeypatch):
    """device=None is the current CUDA device: without one, every entry
    point raises before it proves anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    elf_bytes = elf.make_elf([0x00000073])   # ecall
    calls = [
        lambda: lib.zkvm_execute_and_prove("halt", [], n_bits=5),
        lambda: lib.zkvm_prove_only(None, None, None, [], []),
        lambda: rv32_lib.rv32_execute_and_prove("ecall", n_bits=5),
        lambda: elf.elf_execute_and_prove(elf_bytes, n_bits=5),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
