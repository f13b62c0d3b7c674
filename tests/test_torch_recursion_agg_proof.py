"""The chained aggregated proof of the port on the CPU against the JAX
package's host engine.

tests/test_torch_recursion_agg.py's MEMWALK chain (2^9-row chunks, 2
queries) to the recursive1 proofs of chunks 0 and 1 on the JAX package's
host engine; the port's aggregate_recursive1 of the two with the machine's
ChainMap, at 2^15 rows (the smallest the two-proof circuit fits), on
Engine("cpu"): the aggregated zkin is the JAX package's, byte for byte,
and its publics are the super-chunk's (in-state from chunk 0, out-state
from chunk 1).  One torch thread.
"""
import pytest

from eigen_zkvm_tpu.recursion import aggregation as j_agg
from eigen_zkvm_tpu_torch.recursion import aggregation

from test_torch_recursion import CPU, _host_engine, _one_thread  # noqa: F401
from test_torch_recursion_agg import AGG_BITS, QUERIES, memwalk_chain


@pytest.fixture(scope="module")
def chain():
    return memwalk_chain(2, const_tree=False)


def test_aggregated_proof_is_the_jax_packages(chain):
    got, (_, agg_ss, ps) = aggregation.aggregate_recursive1(
        chain.r1, chain.setup, chain.ss, force_n_bits=AGG_BITS,
        n_queries=QUERIES, chain_map=chain.chain, engine=CPU)
    want, _ = j_agg.aggregate_recursive1(
        chain.r1, chain.j_setup, chain.j_ss, force_n_bits=AGG_BITS,
        n_queries=QUERIES, chain_map=chain.j_chain)
    assert (ps.n_bits, agg_ss.nBits) == (AGG_BITS, AGG_BITS)
    assert got == want
    pub = {nm: int(v) for nm, v in zip(chain.names, got["publics"])}
    first, last = chain.pubs[0], chain.pubs[1]
    assert pub["pc_in"] == first["pc_in"] and pub["x5_out"] == last["x5_out"]
    for j in range(4):
        assert pub[f"mem_in{j}"] == first[f"mem_in{j}"]
        assert pub[f"mem_out{j}"] == last[f"mem_out{j}"]
