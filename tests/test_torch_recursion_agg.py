"""The chained aggregation circuit of the port on the CPU against the JAX
package.

The MiniRV MEMWALK guest of tests/test_zkvm_continuations.py (2^9-row
chunks, a 32-word image, 2 queries) runs to three chunk proofs, each
through c12 and recursive1 (natural sizes: 2^15 and 2^14 rows) on the JAX
package's host engine.  The port sets up the recursive1 circuit from the
JAX package's PIL and constants (convert.plonk_setup_from_jax; its own
const tree, whose root must be the proofs' rootC), then: join_zkin_chain
and ChainMap.for_machine are the JAX package's; the aggregation circuit of
chunks 0 and 1 (build_main with the ChainMap: chunk 0's out-state is
chunk 1's in-state inside the circuit) has the JAX builder's witness,
constraints and packed setup (2^15 rows, the smallest the two-proof
circuit fits); chunks 0 and 2, or a forged boundary public, fail it.  The
aggregated proof is in test_torch_recursion_agg_proof.py.  One torch
thread.
"""
from types import SimpleNamespace

import numpy as np
import pytest

from eigen_zkvm_tpu.recursion import compressor12 as j_c12
from eigen_zkvm_tpu.recursion import stark_verifier_circuit as j_svc
from eigen_zkvm_tpu.recursion.plonk_setup import PlonkSetup as JPlonkSetup
from eigen_zkvm_tpu.stark import serializer as j_ser
from eigen_zkvm_tpu.zkvm import lib as j_lib
from eigen_zkvm_tpu_torch import convert
from eigen_zkvm_tpu_torch.recursion import compressor12
from eigen_zkvm_tpu_torch.recursion.plonk_setup import PlonkSetup
from eigen_zkvm_tpu_torch.recursion.stark_verifier_circuit import build_main
from eigen_zkvm_tpu_torch.stark import serializer
from eigen_zkvm_tpu_torch.stark.stark_setup import StarkSetup
from eigen_zkvm_tpu_torch.stark.starkinfo import StarkInfo

from test_torch_recursion import CPU, _host_engine, _one_thread  # noqa: F401
from test_zkvm_continuations import MEMWALK

NB, RAM_WORDS, SLOTS, N = 9, 32, 24, 220
QUERIES, AGG_BITS = 2, 15


def memwalk_chain(n_r1: int, const_tree: bool = True):
    """The MEMWALK chunk proofs, the recursive1 zkins of the first `n_r1`,
    and the port's recursive1 setup: its own StarkSetup (const tree on the
    CPU), or, without `const_tree`, its own compile beside the JAX setup's
    const root (all an aggregation reads of it)."""
    proofs, pubs, machine, setup, ss = j_lib.zkvm_execute_and_prove(
        MEMWALK, [N, SLOTS], n_bits=NB, n_queries=QUERIES,
        ram_words=RAM_WORDS)
    assert len(proofs) >= 3
    r1 = []
    for p in proofs[:n_r1]:
        c12, (s1, ss1, _) = j_c12.prove_compressed(
            j_ser.stark_proof_to_dict(p, "GL"), setup, ss,
            j_c12.StarkOption(skip_main=True), n_queries=QUERIES)
        p2, (j_st, j_ss, j_ps) = j_c12.prove_compressed(
            j_ser.stark_proof_to_dict(c12, "GL"), s1, ss1,
            j_c12.StarkOption(), n_queries=QUERIES)
        r1.append(j_ser.stark_proof_to_dict(p2, "GL"))
    ps = convert.plonk_setup_from_jax(j_ps)
    ss_port = convert.struct_from_jax(j_ss)
    if const_tree:
        st = StarkSetup(ps.const_pols, ps.pil, ss_port, CPU)
    else:
        si = StarkInfo(ps.pil, ss_port)
        st = SimpleNamespace(starkinfo=si, program=si.program,
                             const_root=j_st.const_root)
    port_machine = SimpleNamespace(pil=convert.pil_from_jax(machine.pil))
    return SimpleNamespace(
        pubs=pubs, r1=r1, names=[p.name for p in machine.pil.publics],
        j_setup=j_st, j_ss=j_ss, j_chain=j_c12.ChainMap.for_machine(machine),
        setup=st, ss=ss_port,
        chain=compressor12.ChainMap.for_machine(port_machine))


@pytest.fixture(scope="module")
def chain():
    return memwalk_chain(3)


def _agg_option(mod, chain_map):
    return mod.StarkOption(verkey_input=True, agg_stage=True,
                           chain_map=chain_map)


def _port_circuit(c, joined, record=True):
    return build_main(joined, c.setup.starkinfo, c.setup.program, c.ss,
                      c.setup.const_root, c.setup.starkinfo.n_publics,
                      _agg_option(compressor12, c.chain), record=record)


def test_recursive1_setup_and_chain_map_match(chain):
    assert [int(x) for x in chain.setup.const_root] == \
        [int(x) for x in chain.j_setup.const_root]
    assert all(z["rootC"] == [str(int(x)) for x in chain.setup.const_root]
               for z in chain.r1)
    assert (chain.chain.pairs, chain.chain.expose) == \
        (chain.j_chain.pairs, chain.j_chain.expose)
    assert serializer.join_zkin(chain.r1[0], chain.r1[1]) == \
        j_ser.join_zkin(chain.r1[0], chain.r1[1])
    assert serializer.join_zkin_chain(chain.r1[0], chain.r1[1], chain.chain) \
        == j_ser.join_zkin_chain(chain.r1[0], chain.r1[1], chain.j_chain)


def test_aggregation_witness_and_setup_match(chain):
    joined = serializer.join_zkin_chain(chain.r1[0], chain.r1[1], chain.chain)
    b = _port_circuit(chain, joined)
    jb = j_svc.build_main(joined, chain.j_setup.starkinfo,
                          chain.j_setup.program, chain.j_ss,
                          chain.j_setup.const_root,
                          chain.j_setup.starkinfo.n_publics,
                          _agg_option(j_c12, chain.j_chain))
    assert b.w == jb.w
    assert b.constraints == jb.constraints
    assert b.custom_gates == jb.custom_gates
    assert b.check()
    assert _port_circuit(chain, joined, record=False).w == b.w
    ps, want = PlonkSetup(b), convert.plonk_setup_from_jax(JPlonkSetup(jb))
    assert (ps.n_bits, ps.n_used) == (AGG_BITS, want.n_used)
    assert np.array_equal(ps.const_pols.buffer, want.const_pols.buffer)
    assert np.array_equal(ps.s_map, want.s_map)


def _rejected(chain, a, b) -> bool:
    try:
        bad = _port_circuit(chain, serializer.join_zkin_chain(a, b,
                                                              chain.chain))
        return not bad.check()
    except AssertionError:  # the builder's build-time constraint check
        return True


def test_a_pair_that_does_not_chain_is_rejected(chain):
    """Chunks 0 and 2 are each valid proofs, but 0's out-state is not 2's
    in-state; a forged boundary public breaks chunk 1's own verifier."""
    assert not _rejected(chain, chain.r1[0], chain.r1[1])
    assert _rejected(chain, chain.r1[0], chain.r1[2])
    forged = dict(chain.r1[1])
    fp = list(forged["publics"])
    i = chain.names.index("x5_in")
    fp[i] = str((int(fp[i]) + 1) % 0xFFFFFFFF00000001)
    forged["publics"] = fp
    assert _rejected(chain, chain.r1[0], forged)
