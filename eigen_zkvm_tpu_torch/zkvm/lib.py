"""zkVM orchestration: execute, chunk, prove, verify — the native analog of
the reference's powdr wrapper (zkvm/src/lib.rs: zkvm_execute_and_prove :168,
zkvm_generate_chunks :231, zkvm_prove_only :280).

Continuations: an unbounded execution is split into fixed 2^n_bits-cycle
chunks; each chunk proof exposes its incoming/outgoing machine state (pc,
registers, tape position) as publics, and `check_chunk_chain` verifies the
boundary handoff — the powdr-bootloader analog.  Chunk proofs are
independent (data-parallel across hosts) and aggregate through the standard
recursion layers (recursion/compressor12.py + join_zkin).

Copy of eigen_zkvm_tpu/zkvm/lib.py for the PyTorch port: the entry points
prove on `device` (None: the current CUDA device, raising without one;
"cpu" is the explicit CPU path) through the port's StarkSetup, stark_gen
and stark_verify.
"""
from __future__ import annotations

import numpy as np

from ..stark.engine import Engine
from ..stark.stark_gen import stark_gen
from ..stark.stark_setup import StarkSetup
from ..stark.stark_verify import stark_verify
from ..stark.types import StarkStruct, Step
from ..utils import structlog
from .isa import Instr, N_REGS, State, assemble, execute
from .machine import MiniRVMachine


def default_struct(n_bits: int, n_queries: int = 8,
                   hash_type: str = "GL") -> StarkStruct:
    steps = []
    nb = n_bits + 1
    while nb > 5:
        steps.append(Step(nb))
        nb -= 4
    steps.append(Step(nb))
    return StarkStruct(nBits=n_bits, nBitsExt=n_bits + 1, nQueries=n_queries,
                       verificationHashType=hash_type, steps=steps)


def zkvm_generate_chunks(program, inputs, n_bits: int = 12,
                         max_cycles: int = 1 << 22,
                         ram_words: int | None = None,
                         image0=None):
    """Execute and split into chunk state-lists of exactly 2^n_bits states
    (the last chunk halts and may be shorter).  Returns (chunks, final);
    with `ram_words` each chunk is (states, image_in) where image_in is the
    RAM image at chunk entry (reference zkvm/src/lib.rs:231
    zkvm_generate_chunks carries bootloader inputs the same way)."""
    if isinstance(program, str):
        program = assemble(program)
    N = 1 << n_bits
    mem = None
    if ram_words is not None:
        image0 = np.zeros(ram_words, dtype=np.uint64) if image0 is None \
            else np.asarray(image0, dtype=np.uint64)
        mem = {a: int(v) for a, v in enumerate(image0) if v}
    states, final = execute(program, inputs, max_cycles=max_cycles, mem=mem)
    assert final.halted, "execution exceeded max_cycles"
    chunks = []
    image = None if ram_words is None else image0.copy()
    pos = 0
    while True:
        chunk = states[pos : pos + N]
        chunks.append(chunk if ram_words is None else (chunk, image.copy()))
        if ram_words is not None:
            # replay the chunk's writes to advance the image
            for st in chunk[1:]:
                if st.mem_op is not None and st.mem_op[2]:
                    image[st.mem_op[0]] = st.mem_op[1]
        if pos + N >= len(states):
            break
        pos += N - 1  # the boundary state is shared between chunks
    return program, chunks, final


def zkvm_prove_only(machine: MiniRVMachine, setup, ss, chunk_states, inputs,
                    image_in=None, device=None):
    """Prove one chunk on `device`; returns (proof, publics dict)."""
    engine = device if isinstance(device, Engine) else Engine(device)
    cm = machine.trace(chunk_states, inputs, image_in=image_in)
    proof = stark_gen(cm, machine.const_pols, setup.const_tree,
                      setup.starkinfo, setup.program, ss, engine=engine)
    ok = stark_verify(proof, setup.const_root, setup.starkinfo, ss,
                      setup.program)
    if not ok:
        raise RuntimeError("chunk proof failed self-verification")
    names = [p.name for p in machine.pil.publics]
    vals = {n: int(proof.publics[i, 0]) for i, n in enumerate(names)}
    return proof, vals


def check_chunk_chain(publics_list, continuations: bool = False) -> bool:
    """Boundary handoff: chunk k's outgoing state == chunk k+1's incoming
    (with continuations, the RAM-image digests chain too)."""
    for a, b in zip(publics_list, publics_list[1:]):
        if a["pc_out"] != b["pc_in"]:
            return False
        if a["in_idx_out"] != b["in_idx_in"]:
            return False
        for i in range(N_REGS):
            if a[f"x{i}_out"] != b[f"x{i}_in"]:
                return False
        if continuations:
            for j in range(4):
                if a[f"mem_out{j}"] != b[f"mem_in{j}"]:
                    return False
    return True


def zkvm_execute_and_prove(program, inputs, n_bits: int = 12,
                           ss: StarkStruct | None = None,
                           n_queries: int = 3,
                           ram_words: int | None = None,
                           image0=None, device=None):
    """Full pipeline: assemble/execute, chunk, prove every chunk on
    `device`, check the continuation chain.  Returns (proofs,
    publics_list, machine, setup, ss).  With `ram_words`, RAM guests run
    across multiple chunks: each chunk proves its incoming/outgoing image
    digests and the chain binds them.
    """
    engine = Engine(device)
    program, chunks, final = zkvm_generate_chunks(
        program, inputs, n_bits, ram_words=ram_words, image0=image0)
    machine = MiniRVMachine(program, n_bits, ram_words=ram_words)
    machine.set_tape(inputs)
    ss = ss or default_struct(n_bits, n_queries)
    setup = StarkSetup(machine.const_pols, machine.pil, ss, engine)
    proofs = []
    publics_list = []
    for k, chunk in enumerate(chunks):
        if ram_words is not None:
            states, image_in = chunk
        else:
            states, image_in = chunk, None
        with structlog.span("zkvm.chunk_prove", chunk=k, rows=len(states),
                            nbits=n_bits,
                            continuations=ram_words is not None):
            proof, pubs = zkvm_prove_only(machine, setup, ss, states,
                                          inputs, image_in=image_in,
                                          device=engine)
        proofs.append(proof)
        publics_list.append(pubs)
    if not check_chunk_chain(publics_list,
                             continuations=ram_words is not None):
        raise RuntimeError("chunk chain mismatch")
    if publics_list[0]["pc_in"] != 0 or publics_list[0]["in_idx_in"] != 0:
        raise RuntimeError("chunk 0 does not start at the initial state")
    if ram_words is not None:
        from .machine import ram_digest

        img0 = np.zeros(ram_words, dtype=np.uint64) if image0 is None \
            else np.asarray(image0, dtype=np.uint64)
        d0 = ram_digest(img0)
        for j in range(4):
            if publics_list[0][f"mem_in{j}"] != d0[j]:
                raise RuntimeError("chunk 0 image digest mismatch")
    return proofs, publics_list, machine, setup, ss
