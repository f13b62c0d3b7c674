"""Compressor-12 pipeline: STARK proof -> verifier circuit -> 12-column PIL
trace, ready to be proven again by the eSTARK prover.

Reference flow (test/recursive_proof_to_snark.sh:30-118): pil2circom ->
circom compile -> compressor12_setup (.pil/.const/.exec) -> compressor12_exec
(WASM witness -> .cm) -> stark_prove.  Native flow: build_main constructs the
verifier circuit with its witness embedded, setup packs it into the PIL
trace, exec scatters the witness — no external compiler or WASM runtime.

The .exec file format (adds + s_map as u64 LE with a 2-word header) is kept
byte-compatible with the reference (compressor12_setup.rs write_exec_file /
compressor12_exec.rs read_exec_file) so artifacts interoperate.

Port of eigen_zkvm_tpu/recursion/compressor12.py.  `prove_compressed` takes
the engine the layer proves on (None: the current CUDA device, raising
without one; `Engine("cpu")` for the tests): its const tree, trace commits,
constraint VM and FRI run there, on the NTT and Poseidon-GL kernels.  A
`prof` (utils/profiler.Prof) gets the layer's host stages and stark_gen's
own ticks.
"""
from __future__ import annotations

import json

import numpy as np

from ..stark.engine import Engine
from ..stark.stark_gen import stark_gen
from ..stark.stark_setup import StarkSetup
from ..stark.stark_verify import stark_verify
from ..stark.types import StarkStruct, Step
from ..utils import structlog
from ..utils.profiler import Prof
from .plonk_setup import PlonkSetup, exec_witness
from .stark_verifier_circuit import build_main


class StarkOption:
    """pil2circom generation flags (reference: starky/src/pil2circom.rs:9).

    `chain_map` (aggregation stage only) additionally constrains the two
    verified proofs as CONSECUTIVE continuation chunks in-circuit — see
    ChainMap / stark_verifier_circuit.build_main."""

    def __init__(self, enable_input=False, verkey_input=False,
                 skip_main=False, agg_stage=False, chain_map=None):
        self.enable_input = enable_input
        self.verkey_input = verkey_input
        self.skip_main = skip_main
        self.agg_stage = agg_stage
        self.chain_map = chain_map


class ChainMap:
    """Continuation binding for the aggregation Main: `pairs` equates
    a_publics[oa] == b_publics[ib] (chunk a's out-state is chunk b's
    in-state); `expose` selects each exposed public from ("a"|"b", idx) so
    the aggregate carries super-chunk publics and can re-enter the fold."""

    def __init__(self, pairs, expose):
        self.pairs = list(pairs)
        self.expose = list(expose)

    @staticmethod
    def for_machine(machine) -> "ChainMap":
        """Derive the map from a MiniRVMachine's publics layout: every
        `*_out` name pairs with its `*_in` twin; exposed publics take _in
        values from chunk a, _out values from chunk b.  (The recursion
        layer appends 4 rootC limbs to each sub proof's publics; those are
        bound separately and stripped from the exposed set, matching
        join_zkin.)"""
        names = [p.name for p in machine.pil.publics]
        idx = {n: i for i, n in enumerate(names)}
        pairs = []
        expose = []
        for i, n in enumerate(names):
            if "_out" in n:
                pairs.append((i, idx[n.replace("_out", "_in")]))
                expose.append(("b", i))
            else:
                expose.append(("a", i))
        return ChainMap(pairs, expose)


def compressor12_setup(zkin: dict, setup, ss, options: StarkOption,
                       force_n_bits: int = 0, prof: Prof | None = None):
    """Build the verifier circuit for one proof shape and pack it.

    Returns (circuit, plonk_setup).  `setup` is the StarkSetup of the PIL
    the proof verifies (provides starkinfo/program/const_root)."""
    circuit = build_main(zkin, setup.starkinfo, setup.program, ss,
                         setup.const_root, setup.starkinfo.n_publics, options)
    if prof:
        prof.tick("build_main")
    psetup = PlonkSetup(circuit, force_n_bits=force_n_bits)
    if prof:
        prof.tick("PlonkSetup")
    return circuit, psetup


def compressor12_exec(zkin: dict, setup, ss, options: StarkOption,
                      plonk_setup: PlonkSetup):
    """Per-proof witness pass: rebuild values only, scatter into cm pols."""
    circuit = build_main(zkin, setup.starkinfo, setup.program, ss,
                         setup.const_root, setup.starkinfo.n_publics, options,
                         record=False)
    return exec_witness(circuit, plonk_setup)


def default_compressor_struct(n_bits: int, n_queries: int = 8) -> StarkStruct:
    """A c12-layer fold schedule matching the reference's shape
    (starky/data/c12.starkStruct.json: blowup 1 bit, 4-ish bit folds)."""
    steps = []
    nb = n_bits + 1
    while nb > 4:
        steps.append(Step(nb))
        nb -= 4
    steps.append(Step(nb))
    return StarkStruct(nBits=n_bits, nBitsExt=n_bits + 1, nQueries=n_queries,
                       verificationHashType="GL", steps=steps)


def write_exec_file(path: str, plonk_setup: PlonkSetup):
    """.exec = a JSON u64 vector [adds_len, n_used, adds..., s_map...]
    (reference: compressor12_setup.rs write_exec_file + io_utils.rs
    write_vec_to_file, which serializes the vec as JSON text)."""
    adds = plonk_setup.plonk_additions
    s_map = plonk_setup.s_map  # [12, n_used]
    n_used = s_map.shape[1]
    out = [len(adds), n_used]
    for a in adds:
        out.extend([a.s1, a.s2, a.c1, a.c2])
    # serialized row-major: word [2 + adds*4 + 12*i + c] = s_map[c][i]
    out.extend(int(s_map[c][i]) for i in range(n_used) for c in range(12))
    with open(path, "w") as f:
        json.dump(out, f, separators=(",", ":"))


def read_exec_file(path: str):
    with open(path) as f:
        buf = json.load(f)
    adds_len, s_map_rows = int(buf[0]), int(buf[1])
    body = np.array(buf[2:], dtype=np.uint64)
    assert body.size == adds_len * 4 + s_map_rows * 12
    adds = body[: adds_len * 4].reshape(adds_len, 4)
    s_map = body[adds_len * 4 :].reshape(s_map_rows, 12).T.copy()
    return adds, s_map


def prove_compressed(zkin: dict, inner_setup, inner_ss, options: StarkOption,
                     c12_ss: StarkStruct | None = None, force_n_bits: int = 0,
                     n_queries: int = 8, engine: Engine | None = None,
                     prof: Prof | None = None):
    """One full recursion layer: verify `zkin` in-circuit, prove the c12
    trace on `engine`.  Returns (proof, c12_setup_bundle) where the bundle
    carries everything the *next* layer needs."""
    engine = engine or Engine()
    stage = ("c12" if options.skip_main else
             "agg" if options.agg_stage else "recursive")
    with structlog.span("recursion.setup", stage=stage,
                        force_n_bits=force_n_bits):
        circuit, psetup = compressor12_setup(zkin, inner_setup, inner_ss,
                                             options,
                                             force_n_bits=force_n_bits,
                                             prof=prof)
    with structlog.span("recursion.exec_witness", stage=stage,
                        nbits=psetup.n_bits):
        cm_pols = exec_witness(circuit, psetup)
    if prof:
        prof.tick("exec_witness")
    if c12_ss is None:
        c12_ss = default_compressor_struct(psetup.n_bits, n_queries)
    assert c12_ss.nBits == psetup.n_bits, (c12_ss.nBits, psetup.n_bits)
    st_setup = StarkSetup(psetup.const_pols, psetup.pil, c12_ss, engine,
                          prof=prof)
    proof = stark_gen(cm_pols, psetup.const_pols, st_setup.const_tree,
                      st_setup.starkinfo, st_setup.program, c12_ss,
                      engine=engine, prof=prof)
    ok = stark_verify(proof, st_setup.const_root, st_setup.starkinfo, c12_ss,
                      st_setup.program)
    if prof:
        prof.tick("stark_verify")
    if not ok:
        raise RuntimeError("compressed proof failed self-verification")
    return proof, (st_setup, c12_ss, psetup)
