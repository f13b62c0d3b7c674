"""RV32IM orchestration: execute, chunk, prove, chain — the rv32
counterpart of zkvm/lib.py (reference zkvm/src/lib.rs:168/231/280).

Chunking accounts for the 2-row sb/sh micro-cycles: each chunk carries at
most 2^n_bits trace ROWS; when an exact fit is impossible the trace pads
with frozen `skip` rows (see zkvm/rv32.py).  With `ram_words`, every chunk
proves incoming/outgoing RAM-image digests exactly like the MiniRV machine
(zkvm/continuations.py).

Copy of eigen_zkvm_tpu/zkvm/rv32_lib.py for the PyTorch port: the entry
point proves on `device` (None: the current CUDA device, raising without
one; "cpu" is the explicit CPU path)."""
from __future__ import annotations

import numpy as np

from ..stark.engine import Engine
from ..stark.stark_gen import stark_gen
from ..stark.stark_setup import StarkSetup
from ..stark.stark_verify import stark_verify
from ..utils import structlog
from .lib import default_struct
from .machine import ram_digest
from .rv32 import Rv32Machine, TWO_CYCLE
from .rv32_isa import RvInstr, assemble, decode, execute


def program_from_words(words) -> dict[int, RvInstr]:
    return {4 * i: decode(w, 4 * i) for i, w in enumerate(words)}


def program_from_asm(src: str) -> dict[int, RvInstr]:
    return program_from_words(assemble(src))


def rv32_generate_chunks(program, entry: int = 0, n_bits: int = 12,
                         ram_words: int | None = None, image0=None,
                         regs0=None, max_cycles: int = 1 << 22,
                         rows_budget: int | None = None,
                         mem_base: int = 0):
    """Execute and split into row-budgeted chunks.  Returns
    (chunks, final) where each chunk is (states, image_in).

    `rows_budget` caps execution rows per chunk below the trace size
    (chunks pad with skip rows), so a short-but-wide guest — e.g. the EVM
    transition whose RAM image needs the full continuation coprocessor —
    can still exercise multi-chunk chaining."""
    N = rows_budget or (1 << n_bits)
    assert N <= 1 << n_bits
    mem = None
    if ram_words is not None:
        image0 = np.zeros(ram_words, dtype=np.uint64) if image0 is None \
            else np.asarray(image0, dtype=np.uint64)
        # executor memory is absolute word-addressed; the image index is
        # relative to mem_base (the loaded segments' origin)
        mem = {mem_base + a: int(v) for a, v in enumerate(image0) if v}
    states, final = execute(program, entry, regs0, mem=mem,
                            max_cycles=max_cycles)
    assert final.halted, "execution exceeded max_cycles"
    chunks = []
    image = None if ram_words is None else image0.copy()
    start = 0
    while True:
        acc = 1  # the boundary state's single row
        i = start
        while i < len(states) - 1:
            cost = 2 if program[states[i].pc].op in TWO_CYCLE else 1
            if acc + cost > N:
                break
            acc += cost
            i += 1
        chunk = states[start : i + 1]
        chunks.append((chunk, None if image is None else image.copy()))
        if image is not None:
            for stx in chunk[1:]:
                mo = stx.mem_op
                if mo is not None and mo[3]:
                    image[mo[0] - mem_base] = mo[2]
        if i >= len(states) - 1:
            break
        start = i  # boundary state shared with the next chunk
    return chunks, final


def rv32_prove_only(machine: Rv32Machine, setup, ss, states, image_in=None,
                    device=None, prof=None):
    """Trace, prove on `device` and self-verify one chunk; returns (proof,
    publics dict).  `prof` receives a "trace" tick, stark_gen's stage
    ticks and a "verify" tick."""
    engine = device if isinstance(device, Engine) else Engine(device)
    cm = machine.trace(states, image_in=image_in)
    if prof is not None:
        prof.tick("trace")
    proof = stark_gen(cm, machine.const_pols, setup.const_tree,
                      setup.starkinfo, setup.program, ss, engine=engine,
                      prof=prof)
    if not stark_verify(proof, setup.const_root, setup.starkinfo, ss,
                        setup.program):
        raise RuntimeError("rv32 chunk proof failed self-verification")
    if prof is not None:
        prof.tick("verify")
    names = [p.name for p in machine.pil.publics]
    return proof, {n: int(proof.publics[i, 0]) for i, n in enumerate(names)}


def rv32_execute_and_prove(program, entry: int = 0, n_bits: int = 12,
                           ram_words: int | None = None, image0=None,
                           regs0=None, ss=None, n_queries: int = 2,
                           rows_budget: int | None = None,
                           mem_base: int = 0, device=None, prof=None):
    """Full pipeline for real RV32IM machine code, proved on `device`.
    Returns (proofs, publics_list, machine, setup, ss).  A `prof`
    (utils/profiler.Prof) gets "execute", "machine", StarkSetup's two
    ticks, then rv32_prove_only's ticks of each chunk in turn (each
    chunk's end at its "verify")."""
    engine = Engine(device)
    if isinstance(program, str):
        program = program_from_asm(program)
    chunks, final = rv32_generate_chunks(program, entry, n_bits,
                                         ram_words=ram_words, image0=image0,
                                         regs0=regs0, rows_budget=rows_budget,
                                         mem_base=mem_base)
    if prof is not None:
        prof.tick("execute")
    machine = Rv32Machine(program, n_bits, ram_words=ram_words,
                          mem_base=mem_base)
    if prof is not None:
        prof.tick("machine")
    ss = ss or default_struct(n_bits, n_queries)
    setup = StarkSetup(machine.const_pols, machine.pil, ss, engine,
                       prof=prof)
    proofs, publics_list = [], []
    for k, (states, image_in) in enumerate(chunks):
        with structlog.span("rv32.chunk_prove", chunk=k, rows=len(states),
                            nbits=n_bits,
                            continuations=ram_words is not None):
            proof, pubs = rv32_prove_only(machine, setup, ss, states,
                                          image_in, device=engine, prof=prof)
        proofs.append(proof)
        publics_list.append(pubs)
    if not check_chain_publics(publics_list):
        raise RuntimeError("rv32 chunk chain mismatch")
    if ram_words is not None:
        img0 = np.zeros(ram_words, dtype=np.uint64) if image0 is None \
            else np.asarray(image0, dtype=np.uint64)
        d0 = ram_digest(img0)
        for j in range(4):
            if publics_list[0][f"mem_in{j}"] != d0[j]:
                raise RuntimeError("chunk 0 image digest mismatch")
    return proofs, publics_list, machine, setup, ss


def check_chain_publics(publics_list) -> bool:
    """Generic boundary handoff: every `*_out` public of chunk k must equal
    the `*_in` twin of chunk k+1 (registers, pc, RAM digests)."""
    for a, b in zip(publics_list, publics_list[1:]):
        for k, v in a.items():
            if "_out" in k:
                kin = k.replace("_out", "_in")
                if kin in b and v != b[kin]:
                    return False
    return True
