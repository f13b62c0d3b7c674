"""N-proof aggregation: fold recursive1 proofs pairwise through ONE shared
aggregation circuit — the library form of the reference's shell loop
(test/stark_aggregation.sh:82-160: join_zkin -> compressor12_exec ->
stark_prove per pair, reusing the recursive2 setup).

Shape discipline (why force_n_bits): the aggregated proof feeds back as an
input of the SAME aggregation circuit, so recursive1 and recursive2
compressor PILs must share n_bits and publics — the reference forces both
to 2^18 (recursive_proof_to_snark.sh:88, stark_aggregation.sh:104); here
the caller picks the common size.

Port of eigen_zkvm_tpu/recursion/aggregation.py; every pair proves on
`engine` (None: the current CUDA device, raising without one), and a
`prof` (utils/profiler.Prof) gets the host stages and stark_gen's ticks.
"""
from __future__ import annotations

from ..stark.engine import Engine
from ..stark.serializer import join_zkin, join_zkin_chain, stark_proof_to_dict
from ..stark.stark_gen import stark_gen
from ..stark.stark_setup import StarkSetup
from ..stark.stark_verify import stark_verify
from ..utils import structlog
from ..utils.profiler import Prof
from .compressor12 import (StarkOption, compressor12_exec,
                           compressor12_setup, default_compressor_struct,
                           exec_witness)


def aggregate_recursive1(zkins: list, r1_setup, r1_ss,
                         force_n_bits: int, n_queries: int = 8,
                         agg_ss=None, chain_map=None,
                         engine: Engine | None = None,
                         prof: Prof | None = None):
    """Fold a list of same-shape recursive1 zkins into one proof.

    r1_setup/r1_ss: the StarkSetup + struct the recursive1 proofs were
    generated with (also the struct the aggregated proofs use, so they can
    re-enter the fold).  force_n_bits must fit the 2-proof circuit AND
    match the recursive1 compressor size.  Returns
    (final_zkin, agg_setup_bundle).

    With `chain_map` (recursion/compressor12.ChainMap) the zkins are
    CONSECUTIVE continuation chunks: the aggregation circuit additionally
    constrains chunk k's out-state publics == chunk k+1's in-state publics
    and exposes super-chunk publics, so the boundary handoff is PROVEN,
    not host-checked (reference zkvm/src/lib.rs:319 + stark_aggregation.sh)."""
    assert len(zkins) >= 2
    engine = engine or Engine()
    opt = StarkOption(verkey_input=True, agg_stage=True, chain_map=chain_map)
    agg_ss = agg_ss or default_compressor_struct(force_n_bits, n_queries)
    assert agg_ss.nBits == force_n_bits

    def join(a, b):
        return join_zkin(a, b) if chain_map is None else \
            join_zkin_chain(a, b, chain_map)

    # build the aggregation circuit layout once, from the first pair
    joined = join(zkins[0], zkins[1])
    circuit, psetup = compressor12_setup(joined, r1_setup, r1_ss, opt,
                                         force_n_bits=force_n_bits,
                                         prof=prof)
    agg_setup = StarkSetup(psetup.const_pols, psetup.pil, agg_ss, engine,
                           prof=prof)

    def prove_pair(joined_zkin, reuse_circuit=None):
        cm = exec_witness(reuse_circuit, psetup) if reuse_circuit else \
            compressor12_exec(joined_zkin, r1_setup, r1_ss, opt, psetup)
        if prof:
            prof.tick("exec_witness")
        proof = stark_gen(cm, psetup.const_pols, agg_setup.const_tree,
                          agg_setup.starkinfo, agg_setup.program, agg_ss,
                          engine=engine, prof=prof)
        ok = stark_verify(proof, agg_setup.const_root, agg_setup.starkinfo,
                          agg_ss, agg_setup.program)
        if prof:
            prof.tick("stark_verify")
        if not ok:
            raise RuntimeError("aggregated proof failed self-verification")
        return stark_proof_to_dict(proof, "GL")

    with structlog.span("recursion.aggregate_pair", pair=0,
                        chained=chain_map is not None):
        acc = prove_pair(joined, reuse_circuit=circuit)
    for i, z in enumerate(zkins[2:], start=1):
        with structlog.span("recursion.aggregate_pair", pair=i,
                            chained=chain_map is not None):
            acc = prove_pair(join(acc, z))
    return acc, (agg_setup, agg_ss, psetup)
